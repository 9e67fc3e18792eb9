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
  ``conv3x3_int8_kernel.launches`` counts its launches.  The kernel is an
  implicit GEMM on Hopper's warpgroup MMA (``wgmma`` s8) with operands that
  TMA brings into a shared-memory ring: one persistent block a SM walks
  tiles of ``th x tw`` output pixels of one image (5 x 25 on the chain's
  maps) by ``bn`` output channels, two consumer warpgroups taking the tiles
  in turns; each k-block is one tap by ``bk`` input channels, one TMA box of
  the activations shifted by the tap, zero-filled past the image.  It
  equals the plain version bit for bit; its times on the card are in
  ``PERF.md`` section 6.
- :func:`tile_plan` and :func:`tile_origin`: that tiling, as the kernel's
  launch function picks it and as its blocks walk it, so that the CPU tests
  can show every output pixel and channel is covered exactly once.
- :func:`conv3x3_int8_ohwi`: picks by the tensor's device, never by
  catching an error: a CUDA tensor goes to the kernel, a CPU tensor to the
  plain version.  :func:`conv3x3_int8` is the same with HWIO weights.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from dream_tpu_torch.ops import cuda_build
from dream_tpu_torch.ops.conv_int32 import conv2d_int32_plain


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
    return conv2d_int32_plain(x_q.permute(0, 3, 1, 2), w_q.permute(0, 3, 1, 2),
                              padding=1).permute(0, 2, 3, 1)


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


class TilePlan(NamedTuple):
    """The kernel's tiling of one launch (``conv3x3_int8_plan`` in the
    source): ``th x tw`` pixels by ``bn`` channels a tile, ``bk`` input
    channels a k-block, ``stages`` in the shared-memory ring, ``tiles`` in
    all, ``blocks`` launched (one a SM at most), ``smem`` bytes of dynamic
    shared memory a block."""

    th: int
    tw: int
    bn: int
    bk: int
    stages: int
    tiles: int
    blocks: int
    smem: int


_RING_BYTES = 200 * 1024
_MAX_STAGES = 8


def tile_plan(b: int, h: int, w: int, ci: int, co: int, sms: int) -> TilePlan:
    """The tiling ``conv3x3_int8_launch`` picks on a card with ``sms`` SMs
    (``plan_tiles`` in the source, line for line): 64 channels a tile when
    ``co <= 64``, else 128; a pixel tile of at most 16384 / bn pixels (256 or
    128: 128 accumulators a thread either way) with the fewest tiles over an
    image, then the least overhang past its edges, then the widest; the
    widest of 128, 64, 32 input channels that divides ``ci``."""
    bn = 64 if co <= 64 else 128
    rows = 16384 // bn
    best = None
    for tw_ in range(min(w, rows), 0, -1):
        th_ = min(h, rows // tw_)
        th_n, tw_n = -(-h // th_), -(-w // tw_)
        key = (th_n * tw_n, th_n * th_ - h + tw_n * tw_ - w)
        if best is None or key < best[0]:
            best = (key, th_, tw_)
    (n, _), th, tw = best
    tiles = b * n * -(-co // bn)
    bk = 128 if ci % 128 == 0 else 64 if ci % 64 == 0 else 32
    stage = (rows + bn) * bk
    stages = min(_RING_BYTES // stage, _MAX_STAGES)
    return TilePlan(th, tw, bn, bk, stages, tiles, min(tiles, sms), stages * stage + 1024)


@functools.lru_cache(maxsize=256)
def _tile_count(b: int, h: int, w: int, ci: int, co: int) -> int:
    return tile_plan(b, h, w, ci, co, 1).tiles


def tile_origin(plan: TilePlan, h: int, w: int, co: int, tile: int) -> Tuple[int, int, int, int]:
    """(image, first row, first column, first channel) of tile ``tile``, in
    the order the kernel's blocks walk them: the channel tiles of one pixel
    tile next to each other, then along a row of tiles, down the image, and
    image after image."""
    n_tiles_n = -(-co // plan.bn)
    tiles_w, tiles_h = -(-w // plan.tw), -(-h // plan.th)
    m = tile // n_tiles_n
    return (m // (tiles_w * tiles_h), (m // tiles_w) % tiles_h * plan.th, m % tiles_w * plan.tw,
            tile % n_tiles_n * plan.bn)


class ConvInt8Kernel:
    """Callable wrapper of the CUDA int8 conv kernel with a launch counter."""

    def __init__(self):
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        # The server's handler threads launch concurrently: the lock keeps
        # the count exact and the library built and loaded once.
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            return self._lib or self._load()

    def _load(self) -> ctypes.CDLL:
        """Build (unless built) and load the library; the caller holds the lock."""
        lib = cuda_build.load("conv_int8_kernel")
        lib.conv3x3_int8_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.conv3x3_int8_launch.restype = ctypes.c_int
        lib.conv3x3_int8_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.conv3x3_int8_plan.restype = ctypes.c_int
        self._lib = lib
        return self._lib

    def plan(self, b: int, h: int, w: int, ci: int, co: int, sms: int) -> TilePlan:
        """The tiling as the built kernel's launch function picks it."""
        out = (ctypes.c_int * 8)()
        err = self.load().conv3x3_int8_plan(b, h, w, ci, co, sms, out)
        if err != 0:
            raise ValueError(f"the int8 conv kernel refuses {(b, h, w, ci, co)}: CUDA error {err}")
        return TilePlan(*out)

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
        if bsz > 65535 or _tile_count(bsz, h, w, ci, co) > 2**31 - 1:
            raise ValueError(f"the int8 conv kernel takes at most 65535 images and 2**31 - 1 tiles, "
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
        with self._lock:
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
