"""Belief-map synthesis and keypoint peak decoding in torch.

Port of ``dream_tpu/ops/belief_maps.py``.  The decode splits in two, as in
the JAX package:

1. map-sized work: the scipy-compatible sigma-3 Gaussian blur, the
   4-neighbour local-max and threshold test, and the scored map (unblurred
   value at peaks, -inf elsewhere) with the per-map peak count.  This is
   :mod:`dream_tpu_torch.ops.score_kernel`: a hand-written CUDA kernel for
   CUDA tensors, its plain torch version for CPU tensors.
2. peak-sized work in torch: top-K over the scored map, 5x5 subpixel
   refinement on the unblurred map, and the multi-peak disambiguation.

Semantics (reference dream/image_proc.py:913-1018, dream/network.py:540-577):
a pixel is a peak iff its blurred value is >= its 4 neighbours (0 outside
the map) and > 0.01; its score is the unblurred value there; refinement is
a 5x5 weighted average with out-of-map taps weighing 0, falling back to the
integer location when the weights sum to 0; 1 peak -> use it, >1 -> use the
best iff it beats the runner-up by >= 0.25, else the (-999.999, -999.999)
sentinel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dream_tpu_torch.ops.score_kernel import score_maps, score_maps_plain

NO_DETECTION_SENTINEL = -999.999  # reference dream/network.py:572
SCORE_GAP_THRESHOLD = 0.25  # reference dream/network.py:191
DEFAULT_MAX_PEAKS = 8
DECODE_BACKENDS = ("auto", "plain")


def create_belief_maps(keypoints: torch.Tensor, image_resolution, sigma: float = 2.0):
    """Per-keypoint Gaussian belief maps ``[..., n_kp, height, width]``.

    Port of ``belief_maps.create_belief_maps``: coords are int-truncated, the
    Gaussian is written only inside the ``+/- 2*sigma`` window, and the map
    stays all zero unless that window lies inside the frame.
    """
    width, height = int(image_resolution[0]), int(image_resolution[1])
    w = int(sigma * 2)
    kp = torch.as_tensor(keypoints, dtype=torch.float32)
    pixel = torch.trunc(kp).to(torch.int64)
    pu, pv = pixel[..., 0, None, None], pixel[..., 1, None, None]
    valid = (pu - w >= 0) & (pu + w + 1 < width) & (pv - w >= 0) & (pv + w + 1 < height)
    xs = torch.arange(width, device=kp.device)
    ys = torch.arange(height, device=kp.device)
    dx = (xs - pu).to(torch.float32)  # [..., 1, W]
    dy = (ys[:, None] - pv).to(torch.float32)  # [..., H, 1]
    g = torch.exp(-(dy**2 + dx**2) / (2.0 * sigma**2))
    in_window = (dy.abs() <= w) & (dx.abs() <= w)
    return torch.where(valid & in_window, g, torch.zeros((), device=kp.device))


def _subpixel_refine(
    maps: torch.Tensor, scored: torch.Tensor, offset_due_to_upsampling: float,
    max_peaks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K over ``[N, H, W]`` scored maps plus 5x5 subpixel refinement.

    Returns ``(coords [N, K, 2], scores [N, K])``, score-descending.
    """
    n, h, w = maps.shape
    scores, flat_idx = torch.topk(scored.reshape(n, h * w), max_peaks, dim=1)
    py = flat_idx // w
    px = flat_idx % w
    offs = torch.arange(-2, 3, device=maps.device)
    ry = py[:, :, None, None] + offs[:, None]  # [N, K, 5, 1]
    cx = px[:, :, None, None] + offs[None, :]  # [N, K, 1, 5]
    in_bounds = (ry >= 0) & (ry < h) & (cx >= 0) & (cx < w)  # [N, K, 5, 5]
    taps = (ry.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).reshape(n, -1)
    weights = torch.gather(maps.reshape(n, h * w), 1, taps).reshape(in_bounds.shape)
    weights = weights * in_bounds
    i_vals = (ry * in_bounds).to(maps.dtype)
    j_vals = (cx * in_bounds).to(maps.dtype)
    wsum = weights.sum(dim=(2, 3))
    x_avg = (j_vals * weights).sum(dim=(2, 3)) / wsum
    y_avg = (i_vals * weights).sum(dim=(2, 3)) / wsum
    zero_w = wsum == 0.0  # np.average ZeroDivisionError fallback, ref :995-998
    x_ref = torch.where(zero_w, px.to(maps.dtype), x_avg)
    y_ref = torch.where(zero_w, py.to(maps.dtype), y_avg)
    coords = torch.stack([x_ref, y_ref], dim=-1) + offset_due_to_upsampling
    return coords, scores


def peaks_from_belief_maps(
    belief_maps: torch.Tensor,
    offset_due_to_upsampling: float,
    max_peaks: int = DEFAULT_MAX_PEAKS,
    decode_backend: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Batched fixed-shape peak extraction over ``[..., H, W]`` maps.

    Same contract as ``dream_tpu.ops.belief_maps.peaks_from_belief_maps``:
    ``coords [..., K, 2]``, ``scores [..., K]`` (-inf pad), ``valid [..., K]``
    and ``count [...]`` (peak pixels, may exceed K).  The map-sized half runs,
    with ``decode_backend="auto"``, in the CUDA score kernel for CUDA tensors
    and in its plain torch version for CPU tensors; ``"plain"`` runs the
    plain version on any device, which is what ``torch.export`` can trace
    (``dream_tpu_torch/export.py``, as ``dream_tpu/export.py`` asks for
    ``"xla"``).
    """
    if decode_backend not in DECODE_BACKENDS:
        raise ValueError(f"decode_backend must be one of {DECODE_BACKENDS}, got {decode_backend!r}")
    x = belief_maps.to(torch.float32)
    batch_shape = x.shape[:-2]
    h, w = x.shape[-2], x.shape[-1]
    flat = x.reshape(-1, h, w).contiguous()
    scored, count = (score_maps if decode_backend == "auto" else score_maps_plain)(flat)
    coords, scores = _subpixel_refine(flat, scored, offset_due_to_upsampling, max_peaks)
    valid = torch.arange(max_peaks, device=flat.device)[None, :] < count[:, None]
    return {
        "coords": coords.reshape(batch_shape + (max_peaks, 2)),
        "scores": scores.reshape(batch_shape + (max_peaks,)),
        "valid": valid.reshape(batch_shape + (max_peaks,)),
        "count": count.reshape(batch_shape),
    }


def keypoints_from_belief_maps(
    belief_maps: torch.Tensor,
    offset_due_to_upsampling: float,
    use_belief_peak_scores: bool = True,
    belief_peak_next_best_score: float = SCORE_GAP_THRESHOLD,
    max_peaks: int = DEFAULT_MAX_PEAKS,
    decode_backend: str = "auto",
):
    """Peaks plus multi-peak disambiguation -> ``(keypoints [..., 2], peaks)``.

    Maps that cannot be resolved get the ``(-999.999, -999.999)`` sentinel.
    ``decode_backend`` is :func:`peaks_from_belief_maps`'s.
    """
    peaks = peaks_from_belief_maps(belief_maps, offset_due_to_upsampling, max_peaks,
                                   decode_backend)
    count = peaks["count"]
    best = peaks["coords"][..., 0, :]
    if use_belief_peak_scores:
        gap = peaks["scores"][..., 0] - peaks["scores"][..., 1]
        multi_ok = gap >= belief_peak_next_best_score
    else:
        multi_ok = torch.zeros_like(count, dtype=torch.bool)
    keep = (count == 1) | ((count > 1) & multi_ok)
    sentinel = torch.full_like(best, NO_DETECTION_SENTINEL)
    keypoints = torch.where(keep[..., None], best, sentinel)
    return keypoints, peaks
