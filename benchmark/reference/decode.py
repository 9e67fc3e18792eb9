"""Peak decoding of belief maps and the net-output -> raw-frame map, plain
PyTorch float32 (NVlabs/DREAM ``dream/image_proc.py`` ``peaks_from_belief_maps``
and ``dream/network.py`` ``keypoints_from_belief_maps``).

A pixel is a peak where the map blurred by scipy's sigma-3 Gaussian
(truncated at 4 sigma, reflected borders) is at least its four neighbours (0
outside the map) and above 0.01.  A peak's score is the unblurred value there,
its place the 5x5 weighted mean of the unblurred map around it (taps outside
the map weigh 0).  A map with one peak gives it; with several, the best if its
score beats the next by 0.25 or more; otherwise, or with none, the
(-999.999, -999.999) sentinel.  Maps smaller than 400x400 add 0.4395 to the
peak's place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SENTINEL = -999.999
MAX_PEAKS = 8


def blur_matrix(n: int, sigma: float = 3.0, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    taps = (phi / np.sum(phi)).astype(np.float32)
    op = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for t in range(-radius, radius + 1):
            j = (i + t) % (2 * n)
            op[i, j if j < n else 2 * n - 1 - j] += taps[t + radius]
    return op


def keypoints(maps: torch.Tensor) -> torch.Tensor:
    """``[B, n, h, w]`` float32 maps -> ``[B, n, 2]`` net-output keypoints."""
    b, k, h, w = maps.shape
    flat = maps.reshape(b * k, h, w)
    dev = maps.device
    blurred = torch.from_numpy(blur_matrix(h)).to(dev) @ flat @ torch.from_numpy(blur_matrix(w)).to(dev).T
    pad = F.pad(blurred, (1, 1, 1, 1))
    peak = ((blurred >= pad[:, 0:h, 1:w + 1]) & (blurred >= pad[:, 2:h + 2, 1:w + 1])
            & (blurred >= pad[:, 1:h + 1, 0:w]) & (blurred >= pad[:, 1:h + 1, 2:w + 2])
            & (blurred > 0.01))
    count = peak.sum(dim=(1, 2))
    scored = torch.where(peak, flat, torch.full((), float("-inf"), device=dev))
    scores, idx = torch.topk(scored.reshape(b * k, h * w), MAX_PEAKS, dim=1)
    py, px = idx[:, 0] // w, idx[:, 0] % w
    offs = torch.arange(-2, 3, device=dev)
    ry = py[:, None, None] + offs[:, None]
    rx = px[:, None, None] + offs[None, :]
    inside = (ry >= 0) & (ry < h) & (rx >= 0) & (rx < w)
    rows = torch.arange(b * k, device=dev)[:, None, None]
    wts = flat[rows, ry.clamp(0, h - 1), rx.clamp(0, w - 1)] * inside
    wsum = wts.sum(dim=(1, 2))
    x = torch.where(wsum == 0, px.float(), (rx * inside).float().mul(wts).sum(dim=(1, 2)) / wsum)
    y = torch.where(wsum == 0, py.float(), (ry * inside).float().mul(wts).sum(dim=(1, 2)) / wsum)
    offset = 0.0 if (w >= 400 and h >= 400) else 0.4395
    best = torch.stack([x, y], -1) + offset
    keep = (count == 1) | ((count > 1) & (scores[:, 0] - scores[:, 1] >= 0.25))
    return torch.where(keep[:, None], best, torch.full_like(best, SENTINEL)).reshape(b, k, 2)


def raw_from_netout(kp: torch.Tensor, out_res, net_res, crop) -> torch.Tensor:
    """Net-output keypoints -> raw frame through the net input and the
    shrink-and-crop box ``((width, height), (left, top))``; the sentinel
    stays below -999."""
    (cw, ch), (cx, cy) = crop
    sx = float(net_res[0]) / float(out_res[0]) * float(cw) / float(net_res[0])
    sy = float(net_res[1]) / float(out_res[1]) * float(ch) / float(net_res[1])
    return torch.stack([kp[..., 0] * sx + float(cx), kp[..., 1] * sy + float(cy)], -1)
