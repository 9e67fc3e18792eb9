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
  from the same dense operator.  :func:`_blur_table` and :func:`_edge_table`
  are the band in the compact forms the kernel reads.
- :func:`score_plan`: how the kernel cuts the maps into bands, blocks and
  clusters; the wrapper passes it to the kernel, and the CPU tests run a
  numpy model of the kernel under it.
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
import dataclasses
import functools
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dream_tpu_torch.ops import cuda_build

PEAK_THRESHOLD = 0.01  # reference dream/image_proc.py:925
PEAK_BLUR_SIGMA = 3  # reference dream/image_proc.py:926

_RADIUS = 12  # the sigma-3 Gaussian's reach, int(4 * 3 + 0.5)
_TAPS = 2 * _RADIUS + 1
_HALO = _RADIUS + 1  # input rows a band reads beyond its own, each side
_EDGE_SLOTS = 2 * _RADIUS  # border columns, 12 at each side
_MAX_CLUSTER = 8  # blocks a map: the portable thread block cluster size
# Shared memory up to which a map stays on one block (a 100x100 map takes
# 80,000 bytes), and the most a block may take on sm_90: the 227 KB opt-in
# limit less the kernel's static shared memory (80 bytes), rounded down.
_SMEM_TARGET = 100 * 1024
_SMEM_MAX = 232448 - 128


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


@functools.lru_cache(maxsize=None)
def _blur_table(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """``[25, 25]`` compact form of :func:`_blur_band`, the kernel's weights.

    For ``n >= 25``: the 12 folded rows at the top, one interior row (every
    row ``12 <= i < n - 12`` is the unfolded Gaussian, equal to it), the 12
    folded rows at the bottom.  A shorter map keeps its ``n`` rows (the
    rest zero).  :func:`_table_row` maps a row to its table row.
    """
    band = _blur_band(n, sigma, truncate)
    table = np.zeros((_TAPS, _TAPS), np.float32)
    if n < _TAPS:
        table[:n] = band
    else:
        table[:_RADIUS + 1] = band[:_RADIUS + 1]
        table[_RADIUS + 1:] = band[n - _RADIUS:]
    return table


def _edge_slot(x: int, n: int) -> int:
    """Slot of border column ``x`` (``x < 12`` or ``x >= n - 12``) of an
    ``n``-wide map in :func:`_edge_table`."""
    return x if x < _RADIUS else x - n + _EDGE_SLOTS


@functools.lru_cache(maxsize=None)
def _edge_table(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """``[25, 24]`` weights of the border columns, transposed: column ``x``'s
    tap ``t`` at ``[t, _edge_slot(x, n)]`` (zero where the tap falls outside
    the map), so the kernel reads a tap of 4 neighbouring columns at once."""
    band = _blur_band(n, sigma, truncate)
    table = np.zeros((_TAPS, _EDGE_SLOTS), np.float32)
    for x in range(n):
        if x < _RADIUS or x >= n - _RADIUS:
            table[:, _edge_slot(x, n)] = band[x]
    return table


def _table_row(b: int, n: int) -> int:
    """Row of :func:`_blur_table` holding the weights of row ``b`` of ``n``."""
    if n < _TAPS or b < _RADIUS:
        return b
    if b >= n - _RADIUS:
        return b - n + _TAPS
    return _RADIUS


@dataclasses.dataclass(frozen=True)
class ScorePlan:
    """How the kernel cuts ``[N, H, W]`` maps: bands of ``rows`` output rows,
    ``cluster`` blocks a map (a thread block cluster; block k takes bands k,
    k + cluster, ...), ``vec`` columns a thread, ``smem`` bytes of dynamic
    shared memory a block."""

    rows: int
    cluster: int
    bands: int
    vec: int
    smem: int


def smem_bytes(rows: int, h: int, w: int) -> int:
    """A block's dynamic shared memory (``score_kernel_smem_bytes``): a
    band's input rows with 13 more above and below, and its rows with one
    more above and below blurred vertically (the rows blurred both ways take
    the input rows' place)."""
    return 4 * (min(h, rows + 2 * _HALO) + min(h, rows + 2)) * w


@functools.lru_cache(maxsize=None)
def score_plan(h: int, w: int, vec: Optional[int] = None,
               cluster: Optional[int] = None) -> ScorePlan:
    """The kernel's cut of ``h x w`` maps.

    By default a map takes the fewest blocks (1, 2, 4 or 8) whose bands fit
    in ``_SMEM_TARGET``; a 100x100 map is one block (on the H100, 112 maps
    took 0.0140 ms at one block a map, 0.0213 and 0.0359 at clusters of 2
    and 4: ``scripts/compare_score_warp.py``).  A map that does not fit in 8
    such bands takes 8 blocks with the tallest bands that fit the shared
    memory, and each block walks its bands in turn; a band of one row fits
    maps up to 1,936 wide.  ``cluster`` fixes the number of blocks a map (for timing the alternatives); ``vec``
    defaults to 4 where ``w % 4 == 0``.
    """
    vec = vec or (4 if w % 4 == 0 else 1)
    if vec not in (1, 4) or w % vec:
        raise ValueError(f"score kernel takes 1 or 4 columns a thread dividing {w}, got {vec}")
    if cluster is None:
        cluster = next((c for c in (1, 2, 4) if smem_bytes(-(-h // c), h, w) <= _SMEM_TARGET),
                       _MAX_CLUSTER)
    if not 1 <= cluster <= _MAX_CLUSTER:
        raise ValueError(f"a map takes 1 to {_MAX_CLUSTER} blocks, got {cluster}")
    rows = -(-h // cluster)  # then the tallest band that fits
    while rows > 0 and smem_bytes(rows, h, w) > _SMEM_MAX:
        rows -= 1
    if rows == 0:
        raise ValueError(f"belief maps {w} wide do not fit the score kernel's shared memory")
    bands = -(-h // rows)
    cluster = min(cluster, bands)
    return ScorePlan(rows, cluster, bands, vec, smem_bytes(rows, h, w))


class ScoreKernel:
    """Callable wrapper of the CUDA score kernel with a launch counter."""

    def __init__(self):
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        # The server's handler threads launch concurrently: the lock keeps
        # the count exact and the library built and loaded once.
        self._lock = threading.Lock()
        self._tables: Dict[Tuple[int, int, torch.device], Tuple[torch.Tensor, np.ndarray]] = {}

    def load(self) -> ctypes.CDLL:
        with self._lock:
            return self._lib or self._load()

    def _load(self) -> ctypes.CDLL:
        """Build (unless built) and load the library; the caller holds the lock."""
        lib = cuda_build.load("score_kernel")
        lib.score_kernel_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.score_kernel_launch.restype = ctypes.c_int
        lib.score_kernel_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.score_kernel_smem_bytes.restype = ctypes.c_size_t
        for name in ("taps", "max_cluster"):
            getattr(lib, f"score_kernel_{name}").argtypes = []
            getattr(lib, f"score_kernel_{name}").restype = ctypes.c_int
        built = (lib.score_kernel_taps(), lib.score_kernel_max_cluster(),
                 lib.score_kernel_smem_bytes(7, 30, 100), lib.score_kernel_smem_bytes(7, 9, 100))
        if built != (_TAPS, _MAX_CLUSTER, smem_bytes(7, 30, 100), smem_bytes(7, 9, 100)):
            raise RuntimeError(f"the built score kernel (taps, cluster, shared memory) {built} "
                               "does not match its plan")
        self._lib = lib
        return self._lib

    def _table(self, h: int, w: int, device: torch.device) -> Tuple[torch.Tensor, np.ndarray]:
        """The kernel's weights for ``h x w`` maps: the columns' border
        table on the device, and in host memory the rows' blur table then
        the Gaussian (every interior row's and column's weights), which the
        launch passes by value."""
        key = (h, w, device)
        if key not in self._tables:
            sigma = float(PEAK_BLUR_SIGMA)
            weights = np.concatenate([_blur_table(h, sigma).ravel(), _gaussian_kernel_scipy(sigma)[0]])
            self._tables[key] = (torch.from_numpy(_edge_table(w, sigma)).to(device),
                                 np.ascontiguousarray(weights, np.float32))
        return self._tables[key]

    def __call__(self, maps: torch.Tensor,
                 plan: Optional[ScorePlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[N, H, W]`` f32 contiguous CUDA maps -> ``(scored, count int32)``;
        ``plan`` defaults to :func:`score_plan`."""
        if not maps.is_cuda:
            raise ValueError("score kernel takes CUDA tensors; use score_maps_plain on the CPU")
        if maps.dtype != torch.float32 or maps.dim() != 3 or not maps.is_contiguous():
            raise ValueError(
                f"score kernel takes contiguous f32 [N, H, W] maps, got "
                f"{maps.dtype} {tuple(maps.shape)} contiguous={maps.is_contiguous()}"
            )
        n, h, w = maps.shape
        if plan is None:
            plan = score_plan(h, w, vec=4 if w % 4 == 0 and maps.data_ptr() % 16 == 0 else 1)
        scored = torch.empty_like(maps)
        count = torch.empty(n, dtype=torch.int32, device=maps.device)
        if n == 0:
            return scored, count
        lib = self.load()
        edge, weights = self._table(h, w, maps.device)
        with torch.cuda.device(maps.device):
            stream = torch.cuda.current_stream(maps.device).cuda_stream
            err = lib.score_kernel_launch(
                maps.data_ptr(), edge.data_ptr(), weights.ctypes.data, scored.data_ptr(),
                count.data_ptr(), n, h, w, plan.rows, plan.cluster, plan.vec, PEAK_THRESHOLD,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"score kernel launch failed: CUDA error {err}")
        with self._lock:
            self.launches += 1
        return scored, count


score_maps_kernel = ScoreKernel()


def score_maps(maps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if maps.is_cuda:
        return score_maps_kernel(maps)
    return score_maps_plain(maps)
