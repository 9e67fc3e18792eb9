// Peak-score kernel for belief-map decoding, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dream_tpu/ops/pallas_kernels.py:41
// (_score_kernel).  For each f32 [H, W] belief map it computes
//   blurred = T_h @ map @ T_w^T   (scipy-'reflect' sigma-3 Gaussian),
//   peak    = blurred >= its 4 neighbours (0 outside the map) && blurred > thr,
//   scored  = peak ? map : -inf,  count = number of peak pixels.
//
// Design.  The TPU kernel runs the blur as two dense matmuls on the MXU.
// Here the folded operator is banded: every nonzero of row i lies within
// |j - i| <= 12, so the blur is a separable 25-tap filter run directly in
// shared memory, with weights passed in banded form ([n, 25], taken from the
// same dense operator, so the numbers are the same and the taps are summed
// in the same order as a sequential dense product).  One block owns a band
// of output rows of one map: it loads those rows plus a 13-row halo (12 for
// the blur, 1 for the neighbour test), blurs vertically then horizontally,
// tests the peaks and writes its rows of the scored map.  Bands are at most
// 25 rows, so a 100x100 map makes 4 blocks and a batch of 16 vgg-Q frames
// (112 maps) 448 blocks, enough to fill the card; a 400x400 map is cut into
// 16-row bands by shared memory.  Interior taps run fully unrolled; only
// the 12 rows and columns at each border take the bounded loop.  Each block reduces
// its peak count and adds it to the map's count with one atomicAdd, so the
// count is exact in any block order.
//
// Bound.  The work is 50 FMAs (100 flops) a pixel against 8 bytes a pixel
// of device traffic (read the map once, write the scored map once): about
// 12 flops a byte, under the H100's ratio of float32 (non-tensor-core) peak
// to memory rate, about 20.  So the least time is set by the bytes; the
// halo re-reads come from L2.  This first version does not vectorise its
// loads or use TMA; it is simple and exact first.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRadius = 12;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kHalo = kRadius + 1;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ maps, const float* __restrict__ band_h,
             const float* __restrict__ band_wt, float* __restrict__ scored,
             int* __restrict__ count, int H, int W, int rows_per_block,
             int tiles_per_map, float threshold) {
  extern __shared__ float smem[];
  const int n = blockIdx.x / tiles_per_map;
  const int tile = blockIdx.x - n * tiles_per_map;
  const int r0 = tile * rows_per_block;
  const int r1 = min(r0 + rows_per_block, H);  // output rows [r0, r1)
  const int lo = max(0, r0 - kHalo);
  const int hi = min(H, r1 + kHalo);  // input rows [lo, hi)
  const int b0 = max(0, r0 - 1);
  const int b1 = min(H, r1 + 1);  // blurred rows the peak test reads [b0, b1)

  float* in = smem;                                         // (hi-lo) x W
  float* vb = smem + (size_t)(rows_per_block + 2 * kHalo) * W;  // (b1-b0) x W
  float* hb = in;  // the horizontal blur reuses the input rows
  const float* m = maps + (size_t)n * H * W;

  const int n_in = (hi - lo) * W;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) in[i] = m[(size_t)lo * W + i];
  __syncthreads();

  // Vertical blur: vb[b][x] = sum_t band_h[b][t] * map[b + t - R][x].
  const int n_b = (b1 - b0) * W;
  for (int i = threadIdx.x; i < n_b; i += blockDim.x) {
    const int rb = i / W;
    const int x = i - rb * W;
    const int b = b0 + rb;
    const float* wt = band_h + (size_t)b * kTaps;
    const int t0 = max(0, kRadius - b);
    const int t1 = min(kTaps, H - b + kRadius);
    const float* col = in + (size_t)(b + t0 - kRadius - lo) * W + x;
    float acc = 0.f;
    if (t1 - t0 == kTaps) {
#pragma unroll
      for (int t = 0; t < kTaps; ++t) acc = fmaf(wt[t], col[(size_t)t * W], acc);
    } else {
      for (int t = t0; t < t1; ++t) acc = fmaf(wt[t], col[(size_t)(t - t0) * W], acc);
    }
    vb[i] = acc;
  }
  __syncthreads();

  // Horizontal blur: hb[b][x] = sum_t band_w[x][t] * vb[b][x + t - R].  The
  // weights come transposed ([taps][W]) so a warp's loads of one tap are
  // contiguous.
  for (int i = threadIdx.x; i < n_b; i += blockDim.x) {
    const int rb = i / W;
    const int x = i - rb * W;
    const int t0 = max(0, kRadius - x);
    const int t1 = min(kTaps, W - x + kRadius);
    const float* row = vb + (size_t)rb * W + (x + t0 - kRadius);
    float acc = 0.f;
    if (t1 - t0 == kTaps) {
#pragma unroll
      for (int t = 0; t < kTaps; ++t) acc = fmaf(band_wt[(size_t)t * W + x], row[t], acc);
    } else {
      for (int t = t0; t < t1; ++t) acc = fmaf(band_wt[(size_t)t * W + x], row[t - t0], acc);
    }
    hb[i] = acc;
  }
  __syncthreads();

  // 4-neighbour local max with zero fill, threshold, scored map.
  int local = 0;
  const int n_out = (r1 - r0) * W;
  float* out = scored + (size_t)n * H * W;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int ry = i / W;
    const int x = i - ry * W;
    const int y = r0 + ry;
    const float* c = hb + (size_t)(y - b0) * W + x;
    const float v = c[0];
    const float up = y >= 1 ? c[-W] : 0.f;
    const float down = y < H - 1 ? c[W] : 0.f;
    const float left = x >= 1 ? c[-1] : 0.f;
    const float right = x < W - 1 ? c[1] : 0.f;
    const bool peak = v >= up && v >= down && v >= left && v >= right && v > threshold;
    out[(size_t)y * W + x] = peak ? m[(size_t)y * W + x] : -CUDART_INF_F;
    local += peak ? 1 : 0;
  }

  // Block reduction of the peak count, then one atomic per block.
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x < 32) {
    int s = threadIdx.x < (blockDim.x >> 5) ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0 && s > 0) atomicAdd(count + n, s);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a given band height and map width.
size_t score_kernel_smem_bytes(int rows_per_block, int W) {
  return (size_t)(2 * rows_per_block + 2 * kHalo + 2) * W * sizeof(float);
}

int score_kernel_taps() { return kTaps; }

// Launches on `stream`; `count` must hold n_maps zeros.  Returns
// cudaGetLastError() after the launch (0 on success).
// band_h is [H][taps], band_wt is [taps][W] (the width band, transposed).
int score_kernel_launch(const float* maps, const float* band_h, const float* band_wt,
                        float* scored, int* count, int n_maps, int H, int W,
                        int rows_per_block, float threshold, void* stream) {
  const size_t smem = score_kernel_smem_bytes(rows_per_block, W);
  // Opt into the most dynamic shared memory the device allows once per
  // device, not at every launch: its per-block opt-in limit less the
  // kernel's static shared memory.
  static int smem_limit[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem_limit[device] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, score_kernel);
    if (err != cudaSuccess) return (int)err;
    const int limit = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    smem_limit[device] = limit;
  }
  if (smem > (size_t)smem_limit[device]) return (int)cudaErrorInvalidValue;
  const int tiles_per_map = (H + rows_per_block - 1) / rows_per_block;
  const long long blocks = (long long)n_maps * tiles_per_map;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  score_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      maps, band_h, band_wt, scored, count, H, W, rows_per_block, tiles_per_map,
      threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
