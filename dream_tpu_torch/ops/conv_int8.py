"""The int8 3x3 conv with its requantizing epilogue: CUDA for CUDA tensors,
plain torch for CPU tensors.

Replaces ``dream_tpu/ops/pallas_conv.py:98`` (``_conv_kernel``, called
through ``conv3x3_int8``).  It computes, for int8 NHWC activations
``[B, H, W, Ci]`` and f32 ``[Co]`` vectors ``k``, ``b``, the same-pad conv
with int32 accumulation, then per channel
``q = clip(round_half_even(relu?(acc * k + b)), lo, 127)`` in float32 with
the product and the sum rounded separately, ``lo = 0`` under ReLU and -127
otherwise, and returns int8 ``[B, H, W, Co]``.  The TPU kernel's halo layout
and 128-lane channel padding are Mosaic's constraints and have no
counterpart here.

Weights: the kernel takes int8 OHWI ``[Co, 3, 3, Ci]`` (each output
channel's taps contiguous), and so does everything here but
:func:`conv3x3_int8`, which takes the JAX package's public HWIO
``[3, 3, Ci, Co]``, as ``conv3x3_int8_reference`` does, and converts.

- :func:`conv3x3_int32_plain`: the exact int32 accumulator, as a float64
  convolution rounded back to integers (every partial sum is an integer
  below 9 * 512 * 127 * 127 < 2**27, far inside float64's exact range, and
  the rounding absorbs any transform-based algorithm's residue).
- :func:`conv3x3_int8_plain`: the plain torch version, that accumulator and
  the epilogue.  The CPU path and the yardstick for the kernel.
- :data:`conv3x3_int8_kernel`: the wrapper of ``csrc/conv_int8_kernel.cu``,
  built with ``nvcc`` on first use (:mod:`dream_tpu_torch.ops.cuda_build`);
  ``conv3x3_int8_kernel.launches`` counts its launches.
- :func:`conv3x3_int8_ohwi`: picks by the tensor's device, never by
  catching an error: a CUDA tensor goes to the kernel, a CPU tensor to the
  plain version.  :func:`conv3x3_int8` is the same with HWIO weights.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from dream_tpu_torch.ops import cuda_build


def _check(x_q: torch.Tensor, w_q: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"activations and weights must be int8, got {x_q.dtype} and {w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4 or tuple(w_q.shape[1:3]) != (3, 3):
        raise ValueError(
            f"expected x_q [B, H, W, Ci] and OHWI w_q [Co, 3, 3, Ci], got {tuple(x_q.shape)} "
            f"and {tuple(w_q.shape)}"
        )
    if w_q.shape[3] != x_q.shape[3]:
        raise ValueError(f"w_q has {w_q.shape[3]} input channels, x_q {x_q.shape[3]}")
    co = w_q.shape[0]
    for name, v in (("k", k), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (co,):
            raise ValueError(f"{name} must be f32 [{co}], got {v.dtype} {tuple(v.shape)}")
    devices = {t.device for t in (x_q, w_q, k, b)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")


def ohwi(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, Ci, Co]`` -> contiguous OHWI ``[Co, 3, 3, Ci]``."""
    if w_hwio.dim() != 4:
        raise ValueError(f"expected HWIO weights [3, 3, Ci, Co], got {tuple(w_hwio.shape)}")
    return w_hwio.permute(3, 0, 1, 2).contiguous()


def conv3x3_int32_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 NHWC ``[B, H, W, Ci]`` * int8 OHWI ``[Co, 3, 3, Ci]`` -> the
    exact int32 same-pad accumulator, NHWC ``[B, H, W, Co]``."""
    acc = F.conv2d(x_q.permute(0, 3, 1, 2).to(torch.float64),
                   w_q.permute(0, 3, 1, 2).to(torch.float64), padding=1)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1)


def requantize(acc: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """int32 ``[..., Co]`` -> int8: ``clip(round(relu?(acc * k + b)), lo, 127)``
    in float32, each step rounded on its own."""
    y = acc.to(torch.float32) * k + b
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y), 0.0 if relu else -127.0, 127.0).to(torch.int8)


def conv3x3_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                       relu: bool = True) -> torch.Tensor:
    """The plain torch version: int8 ``[B, H, W, Co]``."""
    _check(x_q, w_q, k, b)
    return requantize(conv3x3_int32_plain(x_q, w_q), k, b, relu).contiguous()


class ConvInt8Kernel:
    """Callable wrapper of the CUDA int8 conv kernel with a launch counter."""

    def __init__(self):
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = cuda_build.load("conv_int8_kernel")
            lib.conv3x3_int8_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.conv3x3_int8_launch.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, x_q: torch.Tensor, w_q: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                 relu: bool = True) -> torch.Tensor:
        """Contiguous CUDA tensors: x_q int8 ``[B, H, W, Ci]`` with Ci a
        multiple of 32, w_q int8 OHWI ``[Co, 3, 3, Ci]`` with Co a multiple
        of 8, k and b f32 ``[Co]`` -> int8 ``[B, H, W, Co]``."""
        _check(x_q, w_q, k, b)
        if not x_q.is_cuda:
            raise ValueError("the int8 conv kernel takes CUDA tensors; use conv3x3_int8_plain on the CPU")
        if not all(t.is_contiguous() for t in (x_q, w_q, k, b)):
            raise ValueError("the int8 conv kernel takes contiguous tensors")
        bsz, h, w, ci = x_q.shape
        co = w_q.shape[0]
        if ci % 32 or co % 8:
            raise ValueError(f"the int8 conv kernel needs Ci % 32 == 0 and Co % 8 == 0, got {ci}, {co}")
        if bsz > 65535 or -(-h // 8) * -(-w // 16) > 65535:
            raise ValueError(f"the int8 conv kernel takes at most 65535 images and 65535 tiles, "
                             f"got {tuple(x_q.shape)}")
        out = torch.empty((bsz, h, w, co), dtype=torch.int8, device=x_q.device)
        if out.numel() == 0:
            return out
        lib = self.load()
        with torch.cuda.device(x_q.device):
            stream = torch.cuda.current_stream(x_q.device).cuda_stream
            err = lib.conv3x3_int8_launch(
                x_q.data_ptr(), w_q.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(),
                bsz, h, w, ci, co, int(relu), stream,
            )
        if err != 0:
            raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out


conv3x3_int8_kernel = ConvInt8Kernel()


def conv3x3_int8_ohwi(x_q: torch.Tensor, w_q: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """OHWI weights: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x_q.is_cuda:
        return conv3x3_int8_kernel(x_q, w_q, k, b, relu)
    return conv3x3_int8_plain(x_q, w_q, k, b, relu)


def conv3x3_int8(x_q: torch.Tensor, w_q: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                 relu: bool = True) -> torch.Tensor:
    """HWIO weights ``[3, 3, Ci, Co]``, as ``conv3x3_int8_reference`` takes
    them: :func:`conv3x3_int8_ohwi` after one transpose."""
    return conv3x3_int8_ohwi(x_q, ohwi(w_q), k, b, relu)
