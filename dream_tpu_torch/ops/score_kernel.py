"""The peak-score kernel: CUDA for CUDA tensors, plain torch for CPU tensors.

Replaces ``dream_tpu/ops/pallas_kernels.py:40`` (``_score_kernel``, called
through ``peaks_from_belief_maps_pallas``).  For each f32 ``[H, W]`` map it
computes the scipy-'reflect' sigma-3 Gaussian blur, the 4-neighbour ``>=``
local max with zero fill at the borders and ``> 0.01``, and returns the
scored map (unblurred value at peaks, -inf elsewhere) with the int32 peak
count per map.

- :func:`_blur_operator` / :func:`_blur_band`: the reflect-folded sigma-3
  blur as a dense operator and in banded form (numpy copies of the JAX
  package's ``belief_maps.py:112-136``); both versions take their weights
  from the same dense operator.
- :func:`score_maps_plain`: the plain torch version, the blur as two dense
  matmuls plus shifted compares (``belief_maps.py:218-243`` of the JAX
  package).  The CPU path and the yardstick for the kernel.
- :data:`score_maps_kernel`: the wrapper of ``csrc/score_kernel.cu``.  The
  source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with
  a C interface under ``dream_tpu_torch/_build/`` on first use
  (:mod:`dream_tpu_torch.ops.cuda_build`) and loaded with ``ctypes``;
  nothing is built at import.  ``score_maps_kernel.launches`` counts its
  launches.
- :func:`score_maps`: picks by the tensor's device, never by catching an
  error: a CUDA tensor goes to the kernel, a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dream_tpu_torch.ops import cuda_build

PEAK_THRESHOLD = 0.01  # reference dream/image_proc.py:925
PEAK_BLUR_SIGMA = 3  # reference dream/image_proc.py:926

# Shared memory a block aims for, and the most it may take on sm_90: the
# 227 KB opt-in limit less the kernel's 32 bytes of static warp sums.
_SMEM_TARGET = 96 * 1024
_SMEM_MAX = 232448 - 32
# Most output rows a block owns: 4 blocks per 100-row map keep a vgg-Q batch
# of 112 maps at 448 blocks, several per SM, where one block per map leaves
# most of the card's 132 SMs with a single short block.
_ROWS_MAX = 25


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_scipy(sigma: float, truncate: float = 4.0):
    """1D Gaussian taps identical to scipy.ndimage.gaussian_filter's."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return (phi / np.sum(phi)).astype(np.float32), radius


@functools.lru_cache(maxsize=None)
def _blur_operator(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Dense ``[n, n]`` 1D blur operator with scipy 'reflect' boundary folding.

    Row i holds the taps that produce blurred[i] from the unpadded signal:
    the Gaussian centred at i with out-of-range taps folded back by
    symmetric reflection.  The blur is ``T_h @ map @ T_w^T``.
    """
    kernel, radius = _gaussian_kernel_scipy(sigma, truncate)
    op = np.zeros((n, n), dtype=np.float32)
    period = 2 * n
    for i in range(n):
        for t in range(-radius, radius + 1):
            j_mod = (i + t) % period
            j_fold = j_mod if j_mod < n else period - 1 - j_mod
            op[i, j_fold] += kernel[t + radius]
    return op


@functools.lru_cache(maxsize=None)
def _blur_band(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """``[n, 2*radius+1]`` banded form of :func:`_blur_operator`.

    ``band[i, t + radius] == T[i, i + t]`` where ``0 <= i + t < n``, else 0.
    Every nonzero of row i lies within ``|j - i| <= radius`` (reflection
    folds a tap back no farther than it reached out, and for n <= radius
    every column is within reach), so the band holds the whole operator.
    """
    op = _blur_operator(n, sigma, truncate)
    _, radius = _gaussian_kernel_scipy(sigma, truncate)
    band = np.zeros((n, 2 * radius + 1), dtype=np.float32)
    for i in range(n):
        for t in range(-radius, radius + 1):
            if 0 <= i + t < n:
                band[i, t + radius] = op[i, i + t]
    return band


def score_maps_plain(maps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N, H, W]`` f32 maps -> ``(scored [N, H, W] f32, count [N] int32)``."""
    n, h, w = maps.shape
    t_h = torch.from_numpy(_blur_operator(h, float(PEAK_BLUR_SIGMA))).to(maps.device)
    t_w = torch.from_numpy(_blur_operator(w, float(PEAK_BLUR_SIGMA))).to(maps.device)
    blurred = torch.matmul(torch.matmul(t_h, maps), t_w.T)
    padded = F.pad(blurred, (1, 1, 1, 1))  # zero fill outside the map
    up = padded[:, 0:h, 1 : w + 1]
    down = padded[:, 2 : h + 2, 1 : w + 1]
    left = padded[:, 1 : h + 1, 0:w]
    right = padded[:, 1 : h + 1, 2 : w + 2]
    peaks = (
        (blurred >= up) & (blurred >= down) & (blurred >= left) & (blurred >= right)
        & (blurred > PEAK_THRESHOLD)
    )
    count = peaks.sum(dim=(1, 2), dtype=torch.int32)
    scored = torch.where(peaks, maps, torch.full((), float("-inf"), device=maps.device))
    return scored, count


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/score_kernel.cu`` into ``_build/`` unless already built;
    returns the library's path (see :mod:`dream_tpu_torch.ops.cuda_build`)."""
    return cuda_build.build("score_kernel", verbose=verbose)


def rows_per_block(h: int, w: int) -> int:
    """Output rows one block owns: at most 25, and no more than keep its
    shared memory (input band + 13-row halos + the blurred band) within
    96 KB; at least 1."""
    rows = (_SMEM_TARGET // (4 * w) - 28) // 2
    rows = max(1, min(h, _ROWS_MAX, rows))
    if (2 * rows + 28) * w * 4 > _SMEM_MAX:
        raise ValueError(f"belief maps {w} wide do not fit the score kernel's shared memory")
    return rows


class ScoreKernel:
    """Callable wrapper of the CUDA score kernel with a launch counter."""

    def __init__(self):
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._bands: Dict[Tuple[int, torch.device, bool], torch.Tensor] = {}

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = cuda_build.load("score_kernel")
            lib.score_kernel_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            lib.score_kernel_launch.restype = ctypes.c_int
            lib.score_kernel_taps.argtypes = []
            lib.score_kernel_taps.restype = ctypes.c_int
            _, radius = _gaussian_kernel_scipy(float(PEAK_BLUR_SIGMA))
            if lib.score_kernel_taps() != 2 * radius + 1:
                raise RuntimeError("the built kernel's tap count does not match the blur band")
            self._lib = lib
        return self._lib

    def _band(self, n: int, device: torch.device, transposed: bool) -> torch.Tensor:
        """The ``[n, taps]`` blur band on ``device`` (``[taps, n]`` if transposed)."""
        key = (n, device, transposed)
        if key not in self._bands:
            band = torch.from_numpy(_blur_band(n, float(PEAK_BLUR_SIGMA)))
            self._bands[key] = (band.T if transposed else band).contiguous().to(device)
        return self._bands[key]

    def __call__(self, maps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[N, H, W]`` f32 contiguous CUDA maps -> ``(scored, count int32)``."""
        if not maps.is_cuda:
            raise ValueError("score kernel takes CUDA tensors; use score_maps_plain on the CPU")
        if maps.dtype != torch.float32 or maps.dim() != 3 or not maps.is_contiguous():
            raise ValueError(
                f"score kernel takes contiguous f32 [N, H, W] maps, got "
                f"{maps.dtype} {tuple(maps.shape)} contiguous={maps.is_contiguous()}"
            )
        n, h, w = maps.shape
        lib = self.load()
        band_h = self._band(h, maps.device, transposed=False)
        band_wt = self._band(w, maps.device, transposed=True)
        rows = rows_per_block(h, w)
        scored = torch.empty_like(maps)
        count = torch.zeros(n, dtype=torch.int32, device=maps.device)
        if n == 0:
            return scored, count
        with torch.cuda.device(maps.device):
            stream = torch.cuda.current_stream(maps.device).cuda_stream
            err = lib.score_kernel_launch(
                maps.data_ptr(), band_h.data_ptr(), band_wt.data_ptr(),
                scored.data_ptr(), count.data_ptr(), n, h, w, rows,
                PEAK_THRESHOLD, stream,
            )
        if err != 0:
            raise RuntimeError(f"score kernel launch failed: CUDA error {err}")
        self.launches += 1
        return scored, count


score_maps_kernel = ScoreKernel()


def score_maps(maps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if maps.is_cuda:
        return score_maps_kernel(maps)
    return score_maps_plain(maps)
