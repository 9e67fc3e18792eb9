"""Differentiable soft-argmax keypoint decoding from heatmaps.

Port of ``dream_tpu/ops/spatial_softmax.py``: a 7x7 average pool, a
max-subtracted temperature softmax over the spatial dims, then the
expectation of the pixel index grids, in float32 on the heatmaps' device
(reference dream/spatial_softmax.py:15-95).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_7x7_same(heatmaps: torch.Tensor) -> torch.Tensor:
    """7x7, stride-1 average pool with zero padding 3, the pads counted
    (``torch.nn.AvgPool2d(7, stride=1, padding=3)``), over the last two
    dims of ``[..., H, W]``, in float32 (``:17-35``)."""
    x = heatmaps.to(torch.float32)
    h, w = x.shape[-2:]
    pooled = F.avg_pool2d(x.reshape(-1, 1, h, w), 7, stride=1, padding=3, count_include_pad=True)
    return pooled.reshape(x.shape)


def soft_argmax(heatmaps: torch.Tensor, beta: torch.Tensor, size_mult: float = 1.0,
                epsilon: float = 1e-8) -> torch.Tensor:
    """Expected (x, y) pixel coordinates ``[..., n_kp, 2]`` of ``[..., n_kp,
    H, W]`` heatmaps under ``softmax(beta * pooled)`` (``:38-74``): the pooled
    maps less their max, ``exp(beta * x)`` with ``beta`` ``[n_kp]`` (or
    broadcastable), normalized by the sum plus ``epsilon``, then the
    expectation of the column and row indices times ``size_mult``."""
    x = heatmaps.to(torch.float32)
    h, w = x.shape[-2:]
    flat = avg_pool_7x7_same(x).reshape(x.shape[:-2] + (h * w,))
    flat = flat - flat.amax(dim=-1, keepdim=True)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
    exp_maps = torch.exp(beta[..., None] * flat)
    probs = (exp_maps / (exp_maps.sum(dim=-1, keepdim=True) + epsilon)).reshape(x.shape)
    cols = torch.arange(w, dtype=torch.float32, device=x.device) * size_mult
    rows = torch.arange(h, dtype=torch.float32, device=x.device) * size_mult
    x_vals = (probs * cols).sum(dim=(-2, -1))
    y_vals = (probs * rows[:, None]).sum(dim=(-2, -1))
    return torch.stack([x_vals, y_vals], dim=-1)
