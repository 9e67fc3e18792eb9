// int8 3x3 same-pad convolution with a requantizing epilogue, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dream_tpu/ops/pallas_conv.py:98
// (_conv_kernel, called through conv3x3_int8).  For int8 NHWC activations
// x [B, H, W, Ci] and int8 weights [Co, 3, 3, Ci] (OHWI, each output
// channel's taps contiguous: the int8 chain quantizes its weights into this
// layout once, and only the public HWIO entry point converts) it computes,
// per output pixel and channel c,
//   acc = sum over the 3x3 taps (zero outside the image) and ci of x * w   (int32)
//   y   = acc * k[c] + b[c]          (float32, the product and the sum each rounded)
//   y   = max(y, 0)                  (when relu)
//   q   = clip(rint(y), lo, 127)     (half to even; lo = 0 under relu, -127 otherwise)
// and stores q as int8 NHWC [B, H, W, Co]: conv3x3_int8_reference's
// arithmetic step for step.
//
// Bound.  The vgg-Q chain does 129 GOP a 400x400 frame against at most
// ~5 MB of activations and 2.4 MB of weights a link, so the least time is
// set by the card's int8 tensor-core operations (1,979 TOP/s dense on an
// H100 SXM), not by its bytes.
//
// Design.  An implicit GEMM on the tensor cores through the warp-level
// integer MMA (mma.sync m16n8k32 s8 x s8 -> s32), which needs no layout of
// the TPU's: no halo-padded [B, H+3, WP, C] activation, no 128-lane channel
// padding.  One block of 4 warps owns an 8x16 tile of output pixels by 64
// output channels; each warp owns two output rows (one m16 fragment a row:
// 16 pixels) by all 64 channels (8 n8 fragments).  The block walks the input
// channels in chunks of 32 (one MMA k-step); for each chunk it stages the
// 10x18-pixel input halo (zero-filled outside the image) and the chunk's
// 9x64 weight rows in shared memory with cp.async, double-buffered so the
// next chunk's copy runs under this chunk's MMAs, and then runs the 9 taps
// as shifted reads of the one staged halo.  Every 32-byte row in shared
// memory has its two 16-byte halves swapped on every other group of four
// rows, so the fragment loads (8 rows x 4 words a warp) hit 32 different
// banks.  The epilogue rounds as the reference does: __int2float_rn, then
// __fmul_rn and __fadd_rn (never contracted into an FMA), fmaxf, rintf and
// the clamp.  Speed work (wgmma with TMA-fed operands, persistent blocks,
// tiles fitted to 25- and 50-pixel maps) is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;    // output rows a block
constexpr int kTileW = 16;   // output columns a block: one m16 fragment a row
constexpr int kBN = 64;      // output channels a block
constexpr int kKC = 32;      // input channels a stage: one MMA k-step
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kWarps = 4;    // each warp: 2 output rows x 64 channels
constexpr int kThreads = kWarps * 32;
constexpr int kNFrags = kBN / 8;
constexpr int kXBytes = kHaloH * kHaloW * kKC;  // 5,760
constexpr int kWBytes = 9 * kBN * kKC;          // 18,432
constexpr int kStageBytes = kXBytes + kWBytes;  // 24,192; two stages fit the 48 KB of static shared memory
constexpr int kXChunks = kHaloH * kHaloW * 2;   // 16-byte copies a stage
constexpr int kWChunks = 9 * kBN * 2;

static_assert(kTileH == 2 * kWarps, "each warp owns two output rows");

// Byte offset of 16-byte half `half` of 32-byte row `row`, halves swapped
// on every other group of four rows.
__device__ __forceinline__ int swz(int row, int half) {
  return row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* base, int row, int half, int byte) {
  return *reinterpret_cast<const uint32_t*>(base + swz(row, half) + byte);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t requant(int acc, float k, float b, bool relu, float lo) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), k), b);
  if (relu) y = fmaxf(y, 0.f);
  y = fminf(fmaxf(rintf(y), lo), 127.f);
  return static_cast<int8_t>(static_cast<int>(y));
}

__global__ void __launch_bounds__(kThreads)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ kvec, const float* __restrict__ bvec,
                    int8_t* __restrict__ out, int H, int W, int Ci, int Co,
                    int tiles_w, int relu) {
  __shared__ __align__(128) unsigned char smem[2 * kStageBytes];

  const int n0 = blockIdx.x * kBN;
  const int y0 = (blockIdx.y / tiles_w) * kTileH;
  const int x0 = (blockIdx.y % tiles_w) * kTileW;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int8_t* xb = x + (size_t)b * H * W * Ci;

  auto load_stage = [&](int chunk, int stage) {
    unsigned char* xs = smem + stage * kStageBytes;
    unsigned char* ws = xs + kXBytes;
    const int ci0 = chunk * kKC;
    for (int i = tid; i < kXChunks; i += kThreads) {
      const int p = i >> 1, half = i & 1;
      const int gy = y0 + p / kHaloW - 1, gx = x0 + p % kHaloW - 1;
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int8_t* src = valid ? xb + ((size_t)gy * W + gx) * Ci + ci0 + half * 16 : x;
      cp_async16(xs + swz(p, half), src, valid);
    }
    for (int i = tid; i < kWChunks; i += kThreads) {
      const int r = i >> 1, half = i & 1;
      const int tap = r / kBN, n = n0 + r % kBN;
      const bool valid = n < Co;
      const int8_t* src = valid ? w + ((size_t)n * 9 + tap) * Ci + ci0 + half * 16 : w;
      cp_async16(ws + swz(r, half), src, valid);
    }
  };

  int acc[2][kNFrags][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNFrags; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int n_chunks = Ci / kKC;
  load_stage(0, 0);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      load_stage(chunk + 1, (chunk + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* xs = smem + (chunk & 1) * kStageBytes;
    const unsigned char* ws = xs + kXBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // Fragment row m is output pixel (row warp*2+mi, column m) of the
        // tile, which reads halo pixel (row + dy, m + dx).
        const int p = (warp * 2 + mi + dy) * kHaloW + g + dx;
        a[mi][0] = lds32(xs, p, 0, t * 4);
        a[mi][1] = lds32(xs, p + 8, 0, t * 4);
        a[mi][2] = lds32(xs, p, 1, t * 4);
        a[mi][3] = lds32(xs, p + 8, 1, t * 4);
      }
#pragma unroll
      for (int ni = 0; ni < kNFrags; ++ni) {
        if (n0 + ni * 8 >= Co) break;  // the same for the whole block
        const int r = tap * kBN + ni * 8 + g;
        const uint32_t b0 = lds32(ws, r, 0, t * 4);
        const uint32_t b1 = lds32(ws, r, 1, t * 4);
        mma_s8(acc[0][ni], a[0], b0, b1);
        mma_s8(acc[1][ni], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  const float lo = relu ? 0.f : -127.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int oy = y0 + warp * 2 + mi;
    if (oy >= H) continue;
#pragma unroll
    for (int ni = 0; ni < kNFrags; ++ni) {
      const int n = n0 + ni * 8 + t * 2;
      if (n >= Co) continue;
      const float k0 = __ldg(kvec + n), k1 = __ldg(kvec + n + 1);
      const float b0 = __ldg(bvec + n), b1 = __ldg(bvec + n + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = x0 + g + half * 8;
        if (ox >= W) continue;
        const uint8_t q0 = static_cast<uint8_t>(requant(acc[mi][ni][2 * half], k0, b0, relu, lo));
        const uint8_t q1 = static_cast<uint8_t>(requant(acc[mi][ni][2 * half + 1], k1, b1, relu, lo));
        int8_t* dst = out + (((size_t)b * H + oy) * W + ox) * Co + n;
        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(q0 | (q1 << 8));
      }
    }
  }
}

}  // namespace

extern "C" {

// x [B, H, W, Ci] int8, w [Co, 3, 3, Ci] int8, k and b [Co] f32, out
// [B, H, W, Co] int8, all contiguous, x and w 16-byte aligned; Ci a multiple
// of 32, Co of 8.  Launches on `stream` and returns the launch's cudaError_t
// (0 on success).
int conv3x3_int8_launch(const int8_t* x, const int8_t* w, const float* k, const float* b,
                        int8_t* out, int B, int H, int W, int Ci, int Co, int relu,
                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || Ci % kKC != 0 || Co % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long tiles_h = (H + kTileH - 1) / kTileH, tiles_w = (W + kTileW - 1) / kTileW;
  if (B > 65535 || tiles_h * tiles_w > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((Co + kBN - 1) / kBN), (unsigned)(tiles_h * tiles_w), (unsigned)B);
  conv3x3_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, k, b, out, H, W, Ci, Co, (int)tiles_w, relu);
  return (int)cudaGetLastError();
}

}  // extern "C"
