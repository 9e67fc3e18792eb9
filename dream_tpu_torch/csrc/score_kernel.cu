// Peak-score kernel for belief-map decoding, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dream_tpu/ops/pallas_kernels.py:40
// (_score_kernel).  For each f32 [H, W] belief map it computes
//   blurred = T_h @ map @ T_w^T   (scipy-'reflect' sigma-3 Gaussian),
//   peak    = blurred >= its 4 neighbours (0 outside the map) && blurred > thr,
//   scored  = peak ? map : -inf,  count = number of peak pixels.
//
// Design.  The TPU kernel runs the blur as two dense matmuls on the MXU.
// Here the folded operator is banded (every nonzero of row i lies within
// |j - i| <= 12), so the blur is a separable 25-tap filter.  Its weights come
// from the same dense operator in a compact table of 25 rows a dimension:
// the 12 folded rows at each border and one interior row, which every
// interior row equals (ops/score_kernel.py:_blur_table; a map shorter than
// 25 keeps all its rows); for the columns, the Gaussian and a transposed
// table of the 24 border columns.  A map is cut into bands of output rows; the
// blocks of one map form a thread block cluster, block k taking bands k,
// k + cluster, ...; a 100x100 map is one band of one block.  For a band, a
// block of 512 threads
//   1. copies the band's rows and 13 more above and below into shared
//      memory with cp.async, all copies in flight at once;
//   2. blurs vertically from there: a thread owns a strip of 8 rows by 4
//      columns (float4; 1 column where W % 4 != 0) and adds each of the
//      strip's 8 + 24 input rows into every output row it reaches, so the
//      32 accumulators stay in registers;
//   3. blurs those rows horizontally, 4 columns a thread from 28 values in
//      registers; border columns run the same 25 taps, taking zeros for
//      the values off the row (their weights are zero there);
//   4. tests the 4-neighbour peaks and writes the scored map (float4),
//      reading the unblurred map again only at the peaks;
// so the blurred map never leaves the SM.  The rows' table and the Gaussian
// are a kernel parameter (__grid_constant__), so they live in the constant
// bank: interior strips and column groups take the 25 Gaussian weights as
// FMA operands from there and test no bounds; border strips read the folded
// table there too, whole warps each so that their bounds and weights are
// the same in every lane.  Border column groups read 4 columns' weights of
// a tap at once from the columns' table in global memory (through L1).
// Shared memory holds only the band's rows, so a block fits a band of one
// row of maps up to 1,936 wide.  Each block sums its peaks; block 0 of the
// cluster adds the blocks' sums through distributed shared memory and
// writes the map's count once, so the counts need no zeroing and no
// atomics.
//
// Exactness.  Every blurred value is the same taps from the same band,
// summed in ascending tap order with fmaf from 0, taps outside the map
// skipped or taken as fmaf(0, 0, acc) == acc (acc is never -0): bit for bit
// what the first version of this kernel computed, whose peaks equal the
// plain torch version's.
//
// Bound.  The work is 50 FMAs (100 flops) a pixel against 8 bytes a pixel
// of device traffic (read the map once, write the scored map once): about
// 12 flops a byte, under the H100's ratio of float32 (non-tensor-core) peak
// to memory rate, about 20, so the least time is set by the bytes: 2.7 us
// at the main path's [112, 100, 100].  One map to an SM, the 50 FMAs a
// pixel issue in about 2 us, and the phases, split by barriers, do not
// overlap: the kernel takes about 5x its bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRadius = 12;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kHalo = kRadius + 1;  // input rows beyond a band: 12 for the blur, 1 for the test
constexpr int kTableRows = kTaps;   // 12 top rows, the interior row, 12 bottom rows
constexpr int kEdgeSlots = 2 * kRadius;  // border columns: 12 at each side
constexpr int kThreads = 512;
constexpr int kStrip = 8;           // output rows of a thread's vertical strip
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;

// Row of the compact table that holds the weights of row b of an n-row map.
__device__ __forceinline__ int table_row(int b, int n) {
  if (n < kTableRows || b < kRadius) return b;
  if (b >= n - kRadius) return b - n + kTableRows;
  return kRadius;
}

// The weights the kernel takes by value (ops/score_kernel.py:_blur_table and
// _gaussian_kernel_scipy).
struct Weights {
  float rows[kTableRows * kTaps];  // the compact blur table of the rows
  float gauss[kTaps];              // the Gaussian: the weights of every interior row and column
};

template <int V>
__device__ __forceinline__ void store_global(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int V>
__device__ __forceinline__ void load_global(const float* __restrict__ p, float* v) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_shared(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void store_shared(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Copies map rows into shared memory with cp.async (16 bytes a copy for
// V = 4, else 4), all in flight at once, and waits for them.
template <int V>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int n) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16u * i),
                   "l"(src + 4 * i));
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(base + 4u * i),
                   "l"(src + i));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Vertical blur of the strip of rows [y0, y0 + rows) at columns [x, x + V)
// from the band's input rows `in` (map rows [lo, hi)) into dst (the strip's
// first row, rows W apart): out[s] = sum over t of w(y0 + s, t) *
// map[y0 + s + t - R], over the taps whose row lies in the map, in
// ascending t (every such row of an output row of the strip is in
// [lo, hi)).  Input row y0 - R + i reaches output s with tap t = i - s, so
// loading the rows in order keeps each output's taps in ascending order.
// kInterior: a full strip of rows with the unfolded Gaussian and all 25
// taps; else the weights of the compact table.
template <int V, bool kInterior>
__device__ __forceinline__ void vblur_strip(const float* __restrict__ in, int lo, int hi,
                                            float* __restrict__ dst, int H, int W,
                                            int x, int y0, int rows, const Weights& wt) {
  float acc[kStrip][V];
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
#pragma unroll
    for (int c = 0; c < V; ++c) acc[s][c] = 0.f;
  }
  int trow[kStrip];
#pragma unroll
  for (int s = 0; s < kStrip; ++s) trow[s] = kInterior ? 0 : table_row(y0 + s, H) * kTaps;
#pragma unroll
  for (int i = 0; i < kStrip + kTaps - 1; ++i) {
    const int r = y0 - kRadius + i;
    if (!kInterior && (r < lo || r >= hi)) continue;
    float v[V];
    load_shared<V>(in + (size_t)(r - lo) * W + x, v);
#pragma unroll
    for (int s = 0; s < kStrip; ++s) {
      const int t = i - s;
      if (t < 0 || t >= kTaps) continue;
      if (kInterior) {
#pragma unroll
        for (int c = 0; c < V; ++c) acc[s][c] = fmaf(wt.gauss[t], v[c], acc[s][c]);
      } else if (s < rows) {
        const float w = wt.rows[trow[s] + t];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[s][c] = fmaf(w, v[c], acc[s][c]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    if (kInterior || s < rows) store_shared<V>(dst + (size_t)s * W + x, acc[s]);
  }
}

// Horizontal blur of columns [x, x + V) of one vertically blurred row into
// dst: out[c] = sum over t of w(x + c, t) * row[x + c + t - R] in ascending
// t.  kInterior: all 25 taps lie in the row, with the Gaussian as the
// weights of every column.  Else the weights of tap t of columns
// x .. x + V - 1 are edge[t * kEdgeSlots .. + V) (the border columns' table,
// transposed, in global memory), zero for taps off the row, and the values
// off the row are taken as zeros, so every column takes all 25 taps:
// fmaf(0, 0, acc) == acc, which is what skipping those taps gives.  A group
// of V values read at once lies wholly in the row or wholly off it (x and R
// are multiples of V, and so is W).
template <int V, bool kInterior>
__device__ __forceinline__ void hblur(const float* __restrict__ row, float* __restrict__ dst,
                                      int W, int x, const Weights& wt,
                                      const float* __restrict__ edge) {
  float v[V + kTaps - 1];
#pragma unroll
  for (int k = 0; k < V + kTaps - 1; k += V) {
    const int c0 = x - kRadius + k;
    if (kInterior || (c0 >= 0 && c0 < W)) {
      load_shared<V>(row + c0, v + k);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) v[k + c] = 0.f;
    }
  }
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    float w[V];
    if (kInterior) {
#pragma unroll
      for (int c = 0; c < V; ++c) w[c] = wt.gauss[t];
    } else {
      load_global<V>(edge + t * kEdgeSlots, w);
    }
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = fmaf(w[c], v[c + t], acc[c]);
  }
  store_shared<V>(dst + x, acc);
}

// Peak test of pixels (y, x .. x + V - 1) on the blurred row hb_row (zero
// fill outside the map), scored write; returns the number of peaks.
template <int V>
__device__ __forceinline__ int peak_test(const float* __restrict__ hb_row,
                                         const float* __restrict__ m_row,
                                         float* __restrict__ out_row, int H, int W, int y, int x,
                                         float threshold) {
  float v[V], up[V], down[V], o[V];
  load_shared<V>(hb_row + x, v);
  if (y >= 1) {
    load_shared<V>(hb_row - W + x, up);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) up[c] = 0.f;
  }
  if (y < H - 1) {
    load_shared<V>(hb_row + W + x, down);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) down[c] = 0.f;
  }
  const float left = x >= 1 ? hb_row[x - 1] : 0.f;
  const float right = x + V < W ? hb_row[x + V] : 0.f;
  int peaks = 0;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const float l = c == 0 ? left : v[c - 1];
    const float r = c == V - 1 ? right : v[c + 1];
    const bool peak = v[c] >= up[c] && v[c] >= down[c] && v[c] >= l && v[c] >= r && v[c] > threshold;
    o[c] = peak ? __ldg(m_row + x + c) : -CUDART_INF_F;  // the map is read at its few peaks only
    peaks += peak ? 1 : 0;
  }
  store_global<V>(out_row + x, o);
  return peaks;
}

// One block of a map's cluster.  edge_w, weights: see score_kernel_launch.
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
score_kernel(const float* __restrict__ maps, const float* __restrict__ edge_w,
             const __grid_constant__ Weights weights, float* __restrict__ scored,
             int* __restrict__ count, int H, int W, int rows, int bands, int cluster,
             float threshold) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int block_sum;
  float* in = smem;                                         // a band's input rows
  float* vb = in + (size_t)min(H, rows + 2 * kHalo) * W;    // its rows blurred vertically
  float* hb = in;  // blurred both ways, over the input rows once they are read
  const int n = blockIdx.x / cluster;
  const int rank = blockIdx.x - n * cluster;
  const float* m = maps + (size_t)n * H * W;
  float* out = scored + (size_t)n * H * W;

  // Column groups of V columns; the interior ones [cg_lo, cg_hi) have all
  // 25 taps inside the row and the Gaussian weights (only when W >= 25).
  const int ncg = W / V;
  const int ncg32 = (ncg + 31) & ~31;
  const int cg_lo = (kRadius + V - 1) / V;
  const int cg_hi = max(cg_lo, W - kRadius - V >= 0 ? (W - kRadius - V) / V + 1 : 0);
  const int n_int_cg = cg_hi - cg_lo;
  const int n_edge_cg = ncg - n_int_cg;

  int local = 0;
  for (int band = rank; band < bands; band += cluster) {
    const int r0 = band * rows;
    const int r1 = min(r0 + rows, H);        // output rows [r0, r1)
    const int b0 = max(0, r0 - 1);
    const int b1 = min(H, r1 + 1);           // blurred rows the peak test reads [b0, b1)
    const int nb = b1 - b0;
    const int lo = max(0, r0 - kHalo);
    const int hi = min(H, r1 + kHalo);       // input rows [lo, hi)
    stage_rows<V>(in, m + (size_t)lo * W, (hi - lo) * W);

    // 1. Vertical blur, strips of kStrip rows from b0.  Interior strips
    // [s_lo, s_hi): y0 >= R and y0 + kStrip <= min(H - R, b1).  The other
    // strips start at a warp and take 32 lanes a 32 column groups, so a
    // warp's row bounds and weights are the same in every lane.
    {
      const int strips = (nb + kStrip - 1) / kStrip;
      const int s_lo = min(strips, b0 >= kRadius ? 0 : (kRadius - b0 + kStrip - 1) / kStrip);
      const int lim = min(H - kRadius, b1) - kStrip - b0;
      const int s_hi = max(s_lo, min(strips, lim >= 0 ? lim / kStrip + 1 : 0));
      const int n_int = (s_hi - s_lo) * ncg;
      const int e_start = (n_int + 31) & ~31;
      const int n_all = e_start + (strips - (s_hi - s_lo)) * ncg32;
      for (int i = threadIdx.x; i < n_all; i += kThreads) {
        if (i < n_int) {
          const int k = i / ncg;
          const int y0 = b0 + (s_lo + k) * kStrip;
          vblur_strip<V, true>(in, lo, hi, vb + (size_t)(y0 - b0) * W, H,
                               W, (i - k * ncg) * V, y0, kStrip, weights);
        } else if (i >= e_start) {
          const int e = i - e_start;
          const int k = e / ncg32;
          const int cg = e - k * ncg32;
          if (cg >= ncg) continue;
          const int j = k < s_lo ? k : k + (s_hi - s_lo);
          const int y0 = b0 + j * kStrip;
          vblur_strip<V, false>(in, lo, hi, vb + (size_t)(y0 - b0) * W, H,
                                W, cg * V, y0, min(kStrip, b1 - y0), weights);
        }
      }
    }
    __syncthreads();

    // 2. Horizontal blur of the band's nb rows, interior column groups first.
    {
      const int n_int = nb * n_int_cg;
      const int n_all = nb * ncg;
      for (int i = threadIdx.x; i < n_all; i += kThreads) {
        if (i < n_int) {
          const int rb = i / n_int_cg;
          const int x = (cg_lo + i - rb * n_int_cg) * V;
          hblur<V, true>(vb + (size_t)rb * W, hb + (size_t)rb * W, W, x, weights, edge_w);
        } else {
          const int e = i - n_int;
          const int rb = e / n_edge_cg;
          const int k = e - rb * n_edge_cg;
          const int x = (k < cg_lo ? k : k + n_int_cg) * V;
          const int slot = x < kRadius ? x : x - W + kEdgeSlots;
          hblur<V, false>(vb + (size_t)rb * W, hb + (size_t)rb * W, W, x, weights, edge_w + slot);
        }
      }
    }
    __syncthreads();

    // 3. Peak test and scored write of the output rows [r0, r1).
    {
      const int n_all = (r1 - r0) * ncg;
      for (int i = threadIdx.x; i < n_all; i += kThreads) {
        const int ry = i / ncg;
        const int y = r0 + ry;
        local += peak_test<V>(hb + (size_t)(y - b0) * W, m + (size_t)y * W, out + (size_t)y * W,
                              H, W, y, (i - ry * ncg) * V, threshold);
      }
    }
    __syncthreads();  // the next band overwrites the input rows, vb and hb
  }

  // The block's peaks, then the map's count, written once.
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x < 32) {
    int s = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) block_sum = s;
  }
  if (cluster == 1) {
    if (threadIdx.x == 0) count[n] = block_sum;
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every block of the map has its sum in shared memory
  if (rank == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int r = 0; r < cluster; ++r) total += *cl.map_shared_rank(&block_sum, r);
    count[n] = total;
  }
  cl.sync();  // the blocks keep their shared memory until block 0 has read it
}

// Opt a kernel into the most dynamic shared memory the device allows (its
// per-block opt-in limit less the kernel's static shared memory), once per
// device; returns the limit in `limit`.
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, int* cache, int* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int bytes = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    cache[device] = bytes;
  }
  *limit = cache[device];
  return cudaSuccess;
}

// A block's dynamic shared memory: a band's input rows (with 13-row halos)
// and its rows blurred vertically (with 1-row halos).
size_t smem_bytes(int rows, int H, int W) {
  return (size_t)(min(H, rows + 2 * kHalo) + min(H, rows + 2)) * W * sizeof(float);
}

template <int V>
int launch(const float* maps, const float* edge_w, const Weights& weights, float* scored,
           int* count, int n_maps, int H, int W, int rows, int cluster, float threshold,
           cudaStream_t stream) {
  static int cache[kMaxDevices] = {};
  int limit = 0;
  cudaError_t err = smem_limit(score_kernel<V>, cache, &limit);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(rows, H, W);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const int bands = (H + rows - 1) / rows;
  const long long blocks = (long long)n_maps * cluster;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, score_kernel<V>, maps, edge_w, weights, scored, count, H, W,
                           rows, bands, cluster, threshold);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int score_kernel_taps() { return kTaps; }
int score_kernel_max_cluster() { return kMaxCluster; }

// Dynamic shared memory of a block for bands of `rows` output rows of an
// H x W map.
size_t score_kernel_smem_bytes(int rows, int H, int W) { return smem_bytes(rows, H, W); }

// maps, scored: [n_maps, H, W] f32 contiguous; edge_w: [25, 24] f32 on the
// device, 16-byte aligned, the border columns' weights transposed ([tap][slot],
// column x < 12 in slot x, x >= W - 12 in slot x - W + 24); weights: 25 * 25
// + 25 f32 in host memory, the compact blur table of H then the Gaussian,
// copied into the launch; count: [n_maps] int32, written (not added to).
// Bands of `rows` output rows, `cluster` blocks a map (at most 8 and at
// most the number of bands), `vec` columns a thread: 4 (W % 4 == 0, maps
// and scored 16-byte aligned) or 1.  Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
int score_kernel_launch(const float* maps, const float* edge_w, const float* weights_host,
                        float* scored, int* count, int n_maps, int H, int W, int rows,
                        int cluster, int vec, float threshold, void* stream) {
  if (n_maps <= 0 || H <= 0 || W <= 0 || rows <= 0 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (cluster > (H + rows - 1) / rows) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Weights weights;
  memcpy(&weights, weights_host, sizeof(Weights));
  if (vec == 4) {
    if (W % 4 != 0 || ((uintptr_t)maps | (uintptr_t)scored) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch<4>(maps, edge_w, weights, scored, count, n_maps, H, W, rows, cluster, threshold,
                     s);
  }
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return launch<1>(maps, edge_w, weights, scored, count, n_maps, H, W, rows, cluster, threshold,
                   s);
}

}  // extern "C"
