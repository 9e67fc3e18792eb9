// Affine warp kernel for the training augmentation, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dream_tpu/ops/pallas_warp.py:74
// (_warp_plane_kernel, called through warp_batch_pallas).  For each f32
// [H, W, C] image of a batch it computes augment._warp_bilinear_reflect101:
// every output pixel (x, y) samples the input at the inverse-affine point
//   src_x = i00*x + i01*y + i02,   src_y = i10*x + i11*y + i12,
// folded into the image with reflect-101 borders (cv2.BORDER_REFLECT_101),
// bilinearly from the 2x2 window at (floor(src_y), floor(src_x)) clamped to
// [0, n-2], all C channels.
//
// Design.  The TPU kernel pads every plane by 112 px, cuts the output into
// (8, 128) tiles and resamples each tile as one-hot hat-weight contractions
// on the MXU, because a gather is slow there; that limits it to rotations of
// at most 15 degrees, scales of at most 1.1 and shifts of 6.25%.  On Hopper
// a gather is an ordinary load, so this kernel is the oracle itself, and
// takes any affine, however many times it folds.  A block computes a 32x32
// tile of one image's output: the grid's x and y are the tiles, its z the
// image, so no thread divides.  Lane l of warp w takes column l of the
// tile's rows w, w + 8, w + 16, w + 24, so a warp's 32 pixels are row
// neighbours and so are their taps (C contiguous channels each, read
// through L1), and the block's source footprint is compact enough for L1 to
// serve the taps that neighbouring rows share.  4 consecutive pixels a
// thread with three 16-byte stores was slower, along whole rows and on
// tiles of 4 or 2 rows a warp alike, and staging a warp's pixels through
// shared memory for 16-byte stores was slower than plain stores (all timed
// with scripts/compare_score_warp.py).
// Each arithmetic step is rounded on its own (__fmul_rn/__fadd_rn never
// contract into an FMA) in the order of the oracle and of the plain torch
// version, so the kernel agrees with the plain version on the same inverse
// affine to the bit.  The fold is the floor-mod of jnp.mod and
// torch.remainder, fmod plus a sign fix; CUDA's fmodf is a loop, and
// fmod(x, m) == x exactly when |x| < m, which holds for every coordinate of
// the augmentation's range, so the kernel calls fmodf only beyond it.  The
// inverse affines come from a [B, 6] f32 device tensor that torch computes,
// so nothing syncs with the host.
//
// Bound.  Each value is read once and written once: 8 bytes against about
// 20 flops a value (C = 3: ~30 flops of coordinates and weights a pixel
// plus 7 a channel), under the H100's ratio of float32 peak to memory rate
// (~20), so the least time is set by the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // a block's output tile: kTileW x kTileH pixels
constexpr int kTileH = 32;
constexpr int kWarps = 8;   // warps a block

// Reflect-101 fold of a coordinate into [0, n-1] (augment._reflect101):
// r = x mod m with m = 2(n-1), floor-mod as jnp.mod; |r|; r > n-1 ? m-r : r.
// fmodf(x, m) returns x itself when |x| < m (and for -0.0); NaN and +-inf
// fail the test and take fmodf, which gives NaN as before.
__device__ __forceinline__ float reflect101(float x, float n_minus_1, float m) {
  float r = fabsf(x) < m ? x : fmodf(x, m);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, m);
  r = fabsf(r);
  return r > n_minus_1 ? __fsub_rn(m, r) : r;
}

// Output pixel (x, y) of image `img` into o[0 .. C).
template <int kC>
__device__ __forceinline__ void sample(const float* __restrict__ img, float* o, int x, int H, int W,
                                       int C, float i00, float i02, float i10, float i12,
                                       float i01y, float i11y) {
  const float xf = (float)x;
  float sx = __fadd_rn(__fadd_rn(__fmul_rn(i00, xf), i01y), i02);
  float sy = __fadd_rn(__fadd_rn(__fmul_rn(i10, xf), i11y), i12);
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  sx = reflect101(sx, wm1, __fmul_rn(2.f, wm1));
  sy = reflect101(sy, hm1, __fmul_rn(2.f, hm1));

  const int x0 = min(max((int)floorf(sx), 0), W - 2);
  const int y0 = min(max((int)floorf(sy), 0), H - 2);
  const float tx = fminf(fmaxf(__fsub_rn(sx, (float)x0), 0.f), 1.f);
  const float ty = fminf(fmaxf(__fsub_rn(sy, (float)y0), 0.f), 1.f);
  const float ux = __fsub_rn(1.f, tx), uy = __fsub_rn(1.f, ty);

  const int c_n = kC > 0 ? kC : C;
  const float* r0 = img + ((size_t)y0 * W + x0) * c_n;
  const float* r1 = r0 + (size_t)W * c_n;
  auto tap = [&](int c) {
    const float v00 = __ldg(r0 + c), v01 = __ldg(r0 + c_n + c);
    const float v10 = __ldg(r1 + c), v11 = __ldg(r1 + c_n + c);
    // v00*(1-tx)*(1-ty) + v01*tx*(1-ty) + v10*(1-tx)*ty + v11*tx*ty, left to right.
    float acc = __fmul_rn(__fmul_rn(v00, ux), uy);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, tx), uy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, ux), ty));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, tx), ty));
    o[c] = acc;
  };
  if constexpr (kC > 0) {
#pragma unroll
    for (int c = 0; c < kC; ++c) tap(c);
  } else {
    for (int c = 0; c < C; ++c) tap(c);
  }
}

// One block: a kTileW x kTileH tile of one image's output; lane l of warp w
// takes column x0 + l of rows y0 + w, y0 + w + kWarps, ...  kC: the channel
// count of the training path's RGB frames (3), or 0 for any C (given at run
// time).
template <int kC>
__global__ void __launch_bounds__(32 * kWarps)
warp_kernel(const float* __restrict__ images, const float* __restrict__ inverse,
            float* __restrict__ out, int H, int W, int C) {
  const int x = (int)blockIdx.x * kTileW + threadIdx.x;
  const int b = blockIdx.z;
  const int c_n = kC > 0 ? kC : C;
  const float* inv = inverse + (size_t)b * 6;
  const float i00 = __ldg(inv + 0), i01 = __ldg(inv + 1), i02 = __ldg(inv + 2);
  const float i10 = __ldg(inv + 3), i11 = __ldg(inv + 4), i12 = __ldg(inv + 5);
  const float* img = images + (size_t)b * H * W * c_n;
  const int y_begin = (int)blockIdx.y * kTileH;
  const int y_end = min(H, y_begin + kTileH);
  for (int y = y_begin + (int)threadIdx.y; y < y_end; y += kWarps) {
    const float yf = (float)y;
    const float i01y = __fmul_rn(i01, yf), i11y = __fmul_rn(i11, yf);
    float* row = out + ((size_t)b * H + y) * W * c_n;
    if (x < W) sample<kC>(img, row + (size_t)x * c_n, x, H, W, C, i00, i02, i10, i12, i01y, i11y);
  }
}

template <int kC>
int launch(const float* images, const float* inverse, float* out, int B, int H, int W, int C,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((W + kTileW - 1) / kTileW), (unsigned)((H + kTileH - 1) / kTileH),
                  (unsigned)B);
  warp_kernel<kC><<<grid, dim3(32, kWarps), 0, stream>>>(images, inverse, out, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// images [B, H, W, C] f32 contiguous, inverse [B, 6] f32 (row-major 2x3 of
// the inverse affine), out [B, H, W, C] f32; H, W >= 2; B <= 65535.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int warp_kernel_launch(const float* images, const float* inverse, float* out, int B, int H,
                       int W, int C, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0 || B > 65535 || (H + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 3) return launch<3>(images, inverse, out, B, H, W, C, s);
  return launch<0>(images, inverse, out, B, H, W, C, s);
}

}  // extern "C"
