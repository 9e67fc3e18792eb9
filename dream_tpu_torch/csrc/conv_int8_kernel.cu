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
// arithmetic step for step.  Integer sums do not depend on their order, so
// the result is the plain version's to the bit.
//
// Bound.  The vgg-Q chain does 129 GOP a 400x400 frame (2.064 TOP at B=16)
// against at most ~5 MB of activations and 2.4 MB of weights a link and
// frame, so the least time is set by the card's int8 tensor-core operations
// (1,979 TOP/s dense on an H100 SXM: 1.04 ms for the chain at B=16), not by
// its bytes.
//
// Design.  An implicit GEMM on the warpgroup MMA (wgmma m64nNk32 s8 x s8 ->
// s32) with both operands in shared memory, brought there by TMA:
// - M is output pixels, N output channels, K the 9 taps x Ci.  A tile is
//   128 pixels by 128 channels, or 256 by 64 when Co <= 64: 128 int32
//   accumulators a thread either way.  Its pixels are th x tw of one image,
//   chosen by plan_tiles for the fewest tiles: 5 x 25 on every map of the
//   chain (25 divides 25, 50, 100 and 200), 125 of 128 rows, 5 x 50 for the
//   64-channel links.
// - A k-block is one tap and BK input channels (128, else 64, else 32: the
//   widest that divides Ci).  Its A operand is one TMA box of the 4-D
//   activation map [B, H, W, Ci] at the tile's origin shifted by the tap:
//   TMA fills what lies outside the image, negative coordinates included,
//   with zeros, so the same padding costs nothing.  Its B operand is one box
//   of the 2-D weight map [Co, 9*Ci] (rows past Co are zeros too).  Both are
//   K-major, as 8-bit wgmma requires, with the layouts as they are in device
//   memory: no repacking.  The boxes land swizzled (128, 64 or 32 bytes, the
//   row width BK) exactly as the wgmma descriptors read them.  Each tap reads
//   its box from L2 anew: 32 KB a k-block of 4.2 M operations, 7.8 bytes a
//   thousand operations.
// - One block of three warpgroups a SM, persistent, walking the tiles with a
//   grid stride (the channel tiles of one pixel tile next to each other, so
//   they share A in L2).  Warpgroup 0 gives up registers (setmaxnreg) and one
//   of its threads issues the TMA loads into a ring of 5-8 stages guarded by
//   full and empty mbarriers.  Warpgroups 1 and 2 take the block's tiles in
//   turns (ping-pong): while one rounds and stores a tile, the other's MMAs
//   run.  A consumer issues BK / 32 x (rows / 64) wgmmas a k-block, keeps
//   one group in flight, and frees a stage once the group that read it has
//   finished; a pair of turn barriers keeps each consumer from waiting on a
//   stage more than one fill ahead.
// - The epilogue rounds as the reference does (__int2float_rn, then __fmul_rn
//   and __fadd_rn, never contracted into an FMA, fmaxf, rintf, the clamp),
//   with k and b staged in shared memory once a tile; two shuffles and byte
//   permutes turn a quad of lanes' 2-channel pieces into whole 8-channel
//   chunks, each stored as one 8-byte word; rows past th * tw and pixels
//   past the image edge are skipped.
// - The tensor maps are encoded on the host at every launch (the activation
//   pointer changes every call) with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda, and passed as
//   __grid_constant__ parameters.

#include <cuda.h>  // CUtensorMap and its enums only: nothing from libcuda is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;     // consumer warpgroups, taking tiles in turns
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kRingBytes = 200 * 1024;
constexpr int kMaxStages = 8;

// A tile is rows_of(BN) pixels by BN channels: 128 x 128 or 256 x 64, 128
// int32 accumulators a consumer thread either way.  A ring stage holds one
// k-block's two operands, BK input channels wide.
constexpr int rows_of(int bn) { return 16384 / bn; }
constexpr int stage_bytes(int bn, int bk) { return (rows_of(bn) + bn) * bk; }
constexpr int stages_of(int bn, int bk) {
  return kRingBytes / stage_bytes(bn, bk) < kMaxStages ? kRingBytes / stage_bytes(bn, bk) : kMaxStages;
}
// Dynamic shared memory a block: the ring and 1 KB of slack to align it.
constexpr int smem_of(int bn, int bk) { return stages_of(bn, bk) * stage_bytes(bn, bk) + 1024; }

template <int BN, int BK>
struct Cfg {
  static constexpr int kHalves = rows_of(BN) / 64;  // m64 wgmmas a k-step
  static constexpr int kABytes = rows_of(BN) * BK;
  static constexpr int kStageBytes = stage_bytes(BN, BK);
  static constexpr int kStages = stages_of(BN, BK);
  static constexpr int kSmem = smem_of(BN, BK);
  static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle atoms aligned");
};

struct Geometry {
  int H, W, Ci, Co, th, tw, tiles_h, tiles_w, n_tiles_n, tiles, relu;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of parity `parity` has completed.  A phase
// that never completes is a fault of the kernel: trap after 4 s rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are BK bytes
// wide, swizzled by BK bytes (128 -> layout 1, 64 -> 2, 32 -> 3), 8-row
// groups 8 * BK bytes apart.  The leading-byte offset is unused here.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = BK == 128 ? 1 : BK == 64 ? 2 : 3;
  constexpr uint64_t sbo = 8 * BK;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((sbo >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A[64 x 32] * B[N x 32]^T, both from shared memory; accumulate = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// clip(rint(relu?(acc * k + b)), lo, 127) as an int8 in the low byte of the
// result, with lo = 0 under ReLU (where max(y, 0) is the clamp's own lower
// bound) and -127 otherwise.  Clamping first and rounding second is the same
// for integer bounds; the clamped value plus 1.5 * 2^23 rounds to the nearest
// integer, ties to even, as rintf does, and leaves it as the low bits of the
// float: two's complement in the low byte.  Two conversions fewer than
// rintf and a float-to-int cast (a NaN becomes lo either way).
__device__ __forceinline__ uint32_t requant(int acc, float k, float b, float lo) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), k), b);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, lo), 127.f), 12582912.f));
}

// Barrier `id` (1 or 2) over the 128 threads of one consumer warpgroup.
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_int8_wgmma(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const float* __restrict__ kvec, const float* __restrict__ bvec,
                   int8_t* __restrict__ out, const Geometry g) {
  using C = Cfg<BN, BK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::kStages];
  __shared__ __align__(8) uint64_t empty_bar[C::kStages];
  // turn_bar[c] lets consumer c start waiting on its next tile's k-blocks
  // once the other has passed the waits of its own, so that no consumer
  // waits on a stage more than one fill ahead (the parities would alias).
  __shared__ __align__(8) uint64_t turn_bar[kConsumers];
  // k[c], k[c + 1], b[c], b[c + 1] of each even channel c of a consumer's tile.
  __shared__ float4 scales[kConsumers][BN / 2];

  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128;
  const int kblocks = 9 * (g.Ci / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 4);  // one arrival a warp of the consuming warpgroup
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(smem_u32(&turn_bar[c]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread keeps the ring full, tile after tile of this
    // block.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&x_map);
      prefetch_map(&w_map);
      const uint32_t tx_bytes = static_cast<uint32_t>(BK * g.tw * g.th + BN * BK);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
        const int n0 = (tile % g.n_tiles_n) * BN;
        int m = tile / g.n_tiles_n;
        const int x0 = (m % g.tiles_w) * g.tw;
        m /= g.tiles_w;
        const int y0 = (m % g.tiles_h) * g.th;
        const int b = m / g.tiles_h;
        for (int chunk = 0; chunk < g.Ci / BK; ++chunk) {
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
            const uint32_t a = ring + stage * C::kStageBytes;
            const uint32_t full = smem_u32(&full_bar[stage]);
            mbar_expect_tx(full, tx_bytes);
            tma_load_4d(a, &x_map, full, chunk * BK, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
            tma_load_2d(a + C::kABytes, &w_map, full, tap * g.Ci + chunk * BK, n0);
            if (++stage == C::kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // The consumers take the block's tiles in turns (ping-pong): while one
    // runs its epilogue, the other's MMAs keep the tensor cores busy.  Each
    // owns a whole tile, kHalves m64 slices of pixel rows by BN channels.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane / 4, t = lane % 4;
    const float lo = g.relu ? 0.f : -127.f;
    // Byte selectors of the epilogue's quad transpose (see there).
    const uint32_t keep_sel = (t & 1) ? 0x7632u : 0x5410u;
    const uint32_t send_sel = (t & 1) ? 0x5410u : 0x7632u;
    const uint32_t lo_sel = t == 0 ? 0x5410u : t == 1 ? 0x1054u : t == 2 ? 0x7632u : 0x3276u;
    const uint32_t hi_sel = t == 0 ? 0x7632u : t == 1 ? 0x3276u : t == 2 ? 0x5410u : 0x1054u;
    float4* const pairs = scales[cw];
    int acc[C::kHalves][BN / 2];
#pragma unroll
    for (int mi = 0; mi < C::kHalves; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0;
    for (long long j = cw, n = 0;; j += kConsumers, ++n) {
      const long long tile_ll = blockIdx.x + j * gridDim.x;
      if (tile_ll >= g.tiles) break;
      const int tile = static_cast<int>(tile_ll);
      const int n0 = (tile % g.n_tiles_n) * BN;
      int m = tile / g.n_tiles_n;
      const int x0 = (m % g.tiles_w) * g.tw;
      m /= g.tiles_w;
      const int y0 = (m % g.tiles_h) * g.th;
      const int b = m / g.tiles_h;

      // The tile's k and b, read now and staged for the epilogue after the
      // MMAs, which hide the loads.
      float4 scale = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tid < BN / 2 && n0 + 2 * tid < g.Co) {
        const int c = n0 + 2 * tid;
        scale = make_float4(__ldg(kvec + c), __ldg(kvec + c + 1), __ldg(bvec + c), __ldg(bvec + c + 1));
      }

      // This tile's k-blocks follow the ring from k-block j * kblocks of the
      // block's sequence.
      const long long first = j * kblocks;
      int stage = static_cast<int>(first % C::kStages);
      uint32_t phase = static_cast<uint32_t>((first / C::kStages) & 1);
      int prev = stage;
      if (n + cw > 0) mbar_wait(smem_u32(&turn_bar[cw]), static_cast<uint32_t>((n + cw - 1) & 1));
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(smem_u32(&full_bar[stage]), phase);
        if (kb == kblocks - 1 && tid == 0) mbar_arrive(smem_u32(&turn_bar[1 - cw]));
        const uint32_t a = ring + stage * C::kStageBytes;
        const uint64_t db = smem_desc<BK>(a + C::kABytes);
#pragma unroll
        for (int mi = 0; mi < C::kHalves; ++mi) fence_regs(acc[mi]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)  // 32 bytes of K a step: 2 in the descriptor's units
#pragma unroll
          for (int mi = 0; mi < C::kHalves; ++mi)
            wgmma_s8<BN>(acc[mi], smem_desc<BK>(a + mi * 64 * BK) + 2 * ks, db + 2 * ks,
                         (kb | ks) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the group before this one has read its stage
#pragma unroll
        for (int mi = 0; mi < C::kHalves; ++mi) fence_regs(acc[mi]);
        if (kb > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < C::kHalves; ++mi) fence_regs(acc[mi]);
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
      named_barrier(1 + cw);  // the previous epilogue has read the staged scales
      if (tid < BN / 2) pairs[tid] = scale;
      named_barrier(1 + cw);  // and these are visible

      // Epilogue.  Register 4j + 2h + e of slice mi holds pixel row
      // 64 mi + 16 warp + 8h + quad of the tile and channel n0 + 8j + 2t + e.
      // A quad of lanes holds 8-channel chunks 4jj .. 4jj + 3 of a row, two
      // channels a lane; two shuffles transpose them so that lane t holds
      // all 8 of chunk 4jj + t and stores them as one 8-byte word.
      int8_t* rows[C::kHalves][2];
      bool valid[C::kHalves][2];
#pragma unroll
      for (int mi = 0; mi < C::kHalves; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mi * 64 + warp * 16 + h * 8 + quad;
          const int ty = row / g.tw, tx = row - ty * g.tw;
          const int y = y0 + ty, x = x0 + tx;
          valid[mi][h] = row < g.th * g.tw && y < g.H && x < g.W;
          rows[mi][h] = out + ((static_cast<size_t>(b) * g.H + y) * g.W + x) * g.Co + n0;
        }
#pragma unroll
      for (int jj = 0; jj < BN / 32; ++jj) {
        float4 s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] = pairs[4 * (4 * jj + q) + t];
        const int chunk8 = 4 * jj + t;
        const bool in_co = n0 + 8 * chunk8 < g.Co;
#pragma unroll
        for (int mi = 0; mi < C::kHalves; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t r[8];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = 4 * (4 * jj + q) + 2 * h;
              r[2 * q] = requant(acc[mi][i], s[q].x, s[q].z, lo);
              r[2 * q + 1] = requant(acc[mi][i + 1], s[q].y, s[q].w, lo);
            }
            // Chunks 0 and 1 (this lane's two channels of each) and 2 and 3.
            const uint32_t c01 = __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
            const uint32_t c23 = __byte_perm(__byte_perm(r[4], r[5], 0x0040), __byte_perm(r[6], r[7], 0x0040), 0x5410);
            // Lanes 0, 1 keep chunks 0, 1 and get lane t ^ 2's; lanes 2, 3
            // keep chunks 2, 3.  Then each lane keeps its own chunk of the
            // two, from itself and lane t ^ 2, and gets it from t ^ 1 and t ^ 3.
            const uint32_t own = (t & 2) ? c23 : c01;
            const uint32_t other = __shfl_xor_sync(0xffffffffu, (t & 2) ? c01 : c23, 2);
            const uint32_t keep = __byte_perm(own, other, keep_sel);
            const uint32_t got = __shfl_xor_sync(0xffffffffu, __byte_perm(own, other, send_sel), 1);
            if (valid[mi][h] && in_co)
              *reinterpret_cast<uint2*>(rows[mi][h] + 8 * chunk8) =
                  make_uint2(__byte_perm(keep, got, lo_sel), __byte_perm(keep, got, hi_sel));
          }
      }
    }
  }
}

// The tile geometry of a launch.  The channel tile BN is 64 when Co <= 64,
// else 128; the pixel tile is th x tw of one image with th * tw at most the
// tile's rows (256 or 128), the fewest tiles over the image, then the least
// overhang past its edges, then the widest.  BK is the widest of 128, 64, 32
// that divides Ci.  Returns false when the tile count does not fit an int.
struct Plan {
  int th, tw, bn, bk, tiles_h, tiles_w, n_tiles_n;
  long long tiles;
};

bool plan_tiles(int B, int H, int W, int Ci, int Co, Plan* p) {
  p->bn = Co <= 64 ? 64 : 128;
  const int rows = rows_of(p->bn);
  long long best = -1, best_over = -1;
  for (int tw = W < rows ? W : rows; tw >= 1; --tw) {
    const int th = H < rows / tw ? H : rows / tw;
    const long long th_n = (H + th - 1) / th, tw_n = (W + tw - 1) / tw;
    const long long n = th_n * tw_n, over = th_n * th - H + tw_n * tw - W;
    if (best < 0 || n < best || (n == best && over < best_over)) {
      best = n;
      best_over = over;
      p->th = th;
      p->tw = tw;
    }
  }
  p->tiles_h = (H + p->th - 1) / p->th;
  p->tiles_w = (W + p->tw - 1) / p->tw;
  p->n_tiles_n = (Co + p->bn - 1) / p->bn;
  p->tiles = static_cast<long long>(B) * best * p->n_tiles_n;
  p->bk = Ci % 128 == 0 ? 128 : Ci % 64 == 0 ? 64 : 32;
  return p->tiles <= 0x7fffffffLL;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int BN, int BK>
cudaError_t launch(const CUtensorMap& x_map, const CUtensorMap& w_map, const float* k,
                   const float* b, int8_t* out, const Geometry& g, int grid, cudaStream_t stream) {
  using C = Cfg<BN, BK>;
  auto kernel = conv3x3_int8_wgmma<BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, C::kSmem, stream>>>(x_map, w_map, k, b, out, g);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch_bk(int bn, const CUtensorMap& x_map, const CUtensorMap& w_map, const float* k,
                      const float* b, int8_t* out, const Geometry& g, int grid, cudaStream_t stream) {
  return bn == 128 ? launch<128, BK>(x_map, w_map, k, b, out, g, grid, stream)
                   : launch<64, BK>(x_map, w_map, k, b, out, g, grid, stream);
}

}  // namespace

extern "C" {

// The tile plan of a launch on a card with `sms` SMs, into plan[8]: th, tw,
// BN, BK, ring stages, tiles, blocks launched, dynamic shared memory bytes.
// Returns 0, or cudaErrorInvalidValue where conv3x3_int8_launch refuses the
// shape.
int conv3x3_int8_plan(int B, int H, int W, int Ci, int Co, int sms, int* plan) {
  Plan p;
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || sms <= 0 || Ci % 32 != 0 ||
      Co % 8 != 0 || B > 65535 || !plan_tiles(B, H, W, Ci, Co, &p))
    return (int)cudaErrorInvalidValue;
  const int out[8] = {p.th, p.tw, p.bn, p.bk, stages_of(p.bn, p.bk), (int)p.tiles,
                      (int)(p.tiles < sms ? p.tiles : sms), smem_of(p.bn, p.bk)};
  for (int i = 0; i < 8; ++i) plan[i] = out[i];
  return 0;
}

// x [B, H, W, Ci] int8, w [Co, 3, 3, Ci] int8, k and b [Co] f32, out
// [B, H, W, Co] int8, all contiguous, x, w and out 16-byte aligned; Ci a
// multiple of 32, Co of 8, B at most 65535.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
int conv3x3_int8_launch(const int8_t* x, const int8_t* w, const float* k, const float* b,
                        int8_t* out, int B, int H, int W, int Ci, int Co, int relu,
                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || Ci % 32 != 0 || Co % 8 != 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!plan_tiles(B, H, W, Ci, Co, &p)) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  // TMA's rules: the base 16-byte aligned (checked above), every stride a
  // multiple of 16 bytes below 2^40 (Ci % 32 == 0 keeps them multiples),
  // every box side at most 256; cuTensorMapEncodeTiled refuses the rest.
  const CUtensorMapSwizzle swizzle = p.bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : p.bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)Ci, (cuuint64_t)W * Ci, (cuuint64_t)H * W * Ci};
  const cuuint32_t x_box[4] = {(cuuint32_t)p.bk, (cuuint32_t)p.tw, (cuuint32_t)p.th, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)9 * Ci, (cuuint64_t)Co};
  const cuuint64_t w_strides[1] = {(cuuint64_t)9 * Ci};
  const cuuint32_t w_box[2] = {(cuuint32_t)p.bk, (cuuint32_t)p.bn};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), x_dims, x_strides,
             x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), w_dims, w_strides,
             w_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const Geometry g{H, W, Ci, Co, p.th, p.tw, p.tiles_h, p.tiles_w, p.n_tiles_n, (int)p.tiles,
                   relu != 0};
  const int grid = (int)(p.tiles < sms ? p.tiles : sms);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.bk == 128) err = launch_bk<128>(p.bn, x_map, w_map, k, b, out, g, grid, s);
  else if (p.bk == 64) err = launch_bk<64>(p.bn, x_map, w_map, k, b, out, g, grid, s);
  else err = launch_bk<32>(p.bn, x_map, w_map, k, b, out, g, grid, s);
  return (int)err;
}

}  // extern "C"
