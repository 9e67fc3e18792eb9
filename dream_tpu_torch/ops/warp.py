"""The augmentation's affine warp: CUDA for CUDA tensors, plain torch for CPU.

Replaces ``dream_tpu/ops/pallas_warp.py:74`` (``_warp_plane_kernel``, called
through ``warp_batch_pallas``), which computes
``augment._warp_bilinear_reflect101`` for every image of a batch: the
inverse warp of a ``[B, H, W, C]`` f32 image by a forward 2x3 affine (the
``cv2.getRotationMatrix2D`` convention of ``augment._affine_matrix``), with
bilinear taps and reflect-101 borders.

- :func:`inverse_affines`: forward ``[B, 2, 3]`` affines -> ``[B, 6]``
  inverse rows, by ``torch.linalg.inv_ex`` of the 3x3 matrices in f32 on
  the affines' device (no host sync), as the JAX package inverts them.
- :func:`warp_batch_plain`: the plain torch version, a batched
  ``_warp_bilinear_reflect101`` (four gathers and the bilinear combine).
  The CPU path and the yardstick for the kernel.
- :data:`warp_batch_kernel`: the wrapper of ``csrc/warp_kernel.cu``, built
  with ``nvcc`` on first use (:mod:`dream_tpu_torch.ops.cuda_build`);
  ``warp_batch_kernel.launches`` counts its launches.  A launch recorded
  into a CUDA graph under capture runs only when the graph is replayed:
  it counts in ``captured`` instead, and whoever replays the graph adds
  its launches with ``count_replays``.
- :func:`warp_batch`: picks by the tensor's device, never by catching an
  error: a CUDA tensor goes to the kernel, a CPU tensor to the plain version.

Both versions round every step in the same order, so on one device and one
inverse they agree to the bit; the kernel takes any affine, where the TPU
kernel is limited to the augmentation's range.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dream_tpu_torch.ops import cuda_build


def inverse_affines(affines: torch.Tensor) -> torch.Tensor:
    """``[B, 2, 3]`` forward affines -> ``[B, 6]`` f32 rows of their inverses."""
    if affines.dim() != 3 or tuple(affines.shape[1:]) != (2, 3):
        raise ValueError(f"affines must be [B, 2, 3], got {tuple(affines.shape)}")
    a = affines.to(torch.float32)
    # [0, 0, 1] made on the device: no host-to-device copy, which a CUDA
    # graph could not hold.
    bottom = torch.eye(3, dtype=torch.float32, device=a.device)[2:]
    full = torch.cat([a, bottom.expand(a.shape[0], 1, 3)], dim=1)
    inv = torch.linalg.inv_ex(full).inverse
    return inv[:, :2, :].reshape(-1, 6).contiguous()


def _reflect101(x: torch.Tensor, n: int) -> torch.Tensor:
    """Fold into ``[0, n-1]`` with reflect-101 borders (``augment._reflect101``;
    ``torch.remainder`` is ``jnp.mod``'s floor-mod, fmod plus a sign fix)."""
    m = 2.0 * (n - 1)
    x = torch.remainder(x, m).abs()
    return torch.where(x > (n - 1), m - x, x)


def _warp_with_inverse(images: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    b, h, w, c = images.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=images.device),
        torch.arange(w, dtype=torch.float32, device=images.device),
        indexing="ij",
    )
    i = inverse[:, :, None, None]  # [B, 6, 1, 1]
    src_x = i[:, 0] * xs + i[:, 1] * ys + i[:, 2]
    src_y = i[:, 3] * xs + i[:, 4] * ys + i[:, 5]
    src_x = _reflect101(src_x, w)
    src_y = _reflect101(src_y, h)
    x0 = torch.floor(src_x).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(src_y).to(torch.int64).clamp(0, h - 2)
    tx = (src_x - x0.to(torch.float32)).clamp(0.0, 1.0).reshape(b, h * w, 1)
    ty = (src_y - y0.to(torch.float32)).clamp(0.0, 1.0).reshape(b, h * w, 1)

    flat = images.reshape(b, h * w, c)
    base = (y0 * w + x0).reshape(b, h * w, 1).expand(b, h * w, c)

    def tap(offset: int) -> torch.Tensor:
        return torch.gather(flat, 1, base + offset)

    v00, v01, v10, v11 = tap(0), tap(1), tap(w), tap(w + 1)
    out = (
        v00 * (1 - tx) * (1 - ty)
        + v01 * tx * (1 - ty)
        + v10 * (1 - tx) * ty
        + v11 * tx * ty
    )
    return out.reshape(b, h, w, c)


def _check_images(images: torch.Tensor) -> None:
    if images.dim() != 4 or images.shape[1] < 2 or images.shape[2] < 2:
        raise ValueError(f"images must be [B, H, W, C] with H, W >= 2, got {tuple(images.shape)}")


def _check(images: torch.Tensor, affines: torch.Tensor) -> None:
    _check_images(images)
    if affines.shape != (images.shape[0], 2, 3):
        raise ValueError(
            f"affines must be [{images.shape[0]}, 2, 3], got {tuple(affines.shape)}"
        )
    if affines.device != images.device:
        raise ValueError(f"affines on {affines.device}, images on {images.device}")


def warp_batch_plain(images: torch.Tensor, affines: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` images, ``[B, 2, 3]`` forward affines -> warped f32 images."""
    _check(images, affines)
    return _warp_with_inverse(images.to(torch.float32), inverse_affines(affines))


class WarpKernel:
    """Callable wrapper of the CUDA warp kernel with a launch counter:
    ``launches`` counts the kernels run, ``captured`` the launches recorded
    into CUDA graphs, which run once a replay."""

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = cuda_build.load("warp_kernel")
            lib.warp_kernel_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.warp_kernel_launch.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, images: torch.Tensor, affines: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, C]`` f32 contiguous CUDA images -> warped images."""
        _check(images, affines)
        return self.launch(images, inverse_affines(affines))

    def launch(self, images: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
        """Launch the kernel on images and their ``[B, 6]`` inverse affines
        (:func:`inverse_affines`) on the same device."""
        if not images.is_cuda:
            raise ValueError("warp kernel takes CUDA tensors; use warp_batch_plain on the CPU")
        if images.dtype != torch.float32 or not images.is_contiguous():
            raise ValueError(
                f"warp kernel takes contiguous f32 images, got {images.dtype} "
                f"contiguous={images.is_contiguous()}"
            )
        _check_images(images)
        b, h, w, c = images.shape
        if (inverse.shape != (b, 6) or inverse.dtype != torch.float32
                or inverse.device != images.device or not inverse.is_contiguous()):
            raise ValueError(f"inverse must be contiguous f32 [{b}, 6] on {images.device}")
        if b > 65535:
            raise ValueError(f"warp kernel takes at most 65535 images a launch, got {b}")
        out = torch.empty_like(images)
        if b == 0 or c == 0:
            return out
        lib = self.load()
        with torch.cuda.device(images.device):
            stream = torch.cuda.current_stream(images.device).cuda_stream
            capturing = torch.cuda.is_current_stream_capturing()
            err = lib.warp_kernel_launch(
                images.data_ptr(), inverse.data_ptr(), out.data_ptr(), b, h, w, c, stream
            )
        if err != 0:
            raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
        if capturing:
            self.captured += 1
        else:
            self.launches += 1
        return out

    def count_replays(self, launches_in_graph: int, replays: int) -> None:
        """Count the launches of ``replays`` replays of a CUDA graph that
        holds ``launches_in_graph`` launches of this kernel."""
        self.launches += launches_in_graph * replays


warp_batch_kernel = WarpKernel()


def warp_batch(images: torch.Tensor, affines: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if images.is_cuda:
        return warp_batch_kernel(images.to(torch.float32).contiguous(), affines)
    return warp_batch_plain(images, affines)
