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
// a gather is an ordinary load, so this kernel is the oracle itself: one
// thread per output pixel of one image, reading its four taps of C
// contiguous channels from the NHWC input (neighbouring threads read
// neighbouring taps, which L1 and L2 serve) and writing C contiguous values.
// The fold takes any coordinate, so any affine is correct, however many
// times it folds.  Each arithmetic step is rounded on its own
// (__fmul_rn/__fadd_rn never contract into an FMA) in the order of the
// oracle and of the plain torch version, so the kernel agrees with the plain
// version on the same inverse affine to the bit.  The fold is fmod plus the
// sign fix of a floor-mod, which is jnp.mod's and torch.remainder's
// definition and is exact.  The inverse affines come from a [B, 6] f32
// device tensor that torch computes, so nothing syncs with the host.
//
// Bound.  Each value is read once and written once: 8 bytes against about
// 20 flops a value (C = 3: ~30 flops of coordinates and weights a pixel
// plus 7 a channel), under the H100's ratio of float32 peak to memory rate
// (~20), so the least time is set by the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Reflect-101 fold of a coordinate into [0, n-1] (augment._reflect101):
// r = x mod m with m = 2(n-1), floor-mod as jnp.mod; |r|; r > n-1 ? m-r : r.
__device__ __forceinline__ float reflect101(float x, float n_minus_1, float m) {
  float r = fmodf(x, m);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, m);
  r = fabsf(r);
  return r > n_minus_1 ? __fsub_rn(m, r) : r;
}

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ images, const float* __restrict__ inverse,
            float* __restrict__ out, int H, int W, int C) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const int y = p / W;
  const int x = p - y * W;
  const float* inv = inverse + (size_t)b * 6;
  const float i00 = __ldg(inv + 0), i01 = __ldg(inv + 1), i02 = __ldg(inv + 2);
  const float i10 = __ldg(inv + 3), i11 = __ldg(inv + 4), i12 = __ldg(inv + 5);
  const float xf = (float)x, yf = (float)y;
  float sx = __fadd_rn(__fadd_rn(__fmul_rn(i00, xf), __fmul_rn(i01, yf)), i02);
  float sy = __fadd_rn(__fadd_rn(__fmul_rn(i10, xf), __fmul_rn(i11, yf)), i12);
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  sx = reflect101(sx, wm1, __fmul_rn(2.f, wm1));
  sy = reflect101(sy, hm1, __fmul_rn(2.f, hm1));

  const int x0 = min(max((int)floorf(sx), 0), W - 2);
  const int y0 = min(max((int)floorf(sy), 0), H - 2);
  const float tx = fminf(fmaxf(__fsub_rn(sx, (float)x0), 0.f), 1.f);
  const float ty = fminf(fmaxf(__fsub_rn(sy, (float)y0), 0.f), 1.f);
  const float ux = __fsub_rn(1.f, tx), uy = __fsub_rn(1.f, ty);

  const float* img = images + (size_t)b * H * W * C;
  const float* r0 = img + ((size_t)y0 * W + x0) * C;
  const float* r1 = r0 + (size_t)W * C;
  float* o = out + ((size_t)b * H * W + p) * C;
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(r0 + c), v01 = __ldg(r0 + C + c);
    const float v10 = __ldg(r1 + c), v11 = __ldg(r1 + C + c);
    // v00*(1-tx)*(1-ty) + v01*tx*(1-ty) + v10*(1-tx)*ty + v11*tx*ty, left to right.
    float acc = __fmul_rn(__fmul_rn(v00, ux), uy);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, tx), uy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, ux), ty));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, tx), ty));
    o[c] = acc;
  }
}

}  // namespace

extern "C" {

// images [B, H, W, C] f32 contiguous, inverse [B, 6] f32 (row-major 2x3 of
// the inverse affine), out [B, H, W, C] f32; H, W >= 2.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
int warp_kernel_launch(const float* images, const float* inverse, float* out,
                       int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)H * W;
  if (pixels > 0x7fffffffLL - kThreads) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((pixels + kThreads - 1) / kThreads), (unsigned)B);
  warp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(images, inverse, out, H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
