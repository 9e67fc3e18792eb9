"""Output heads: the soft-argmax keypoint head.

Port of ``dream_tpu/models/heads.py`` (``SoftArgmax``): soft keypoint
decoding of ``[..., n_kp, H, W]`` heatmaps with a learned or fixed
inverse temperature ``beta`` of shape ``[n_kp]``
(:func:`dream_tpu_torch.ops.spatial_softmax.soft_argmax`).
"""

from __future__ import annotations

import torch
from torch import nn

from dream_tpu_torch.ops.spatial_softmax import soft_argmax


class SoftArgmax(nn.Module):
    """Differentiable keypoint coordinates ``[..., n_kp, 2]`` from heatmaps.
    A learned ``beta`` is a parameter (the flax ``beta`` leaf); a fixed one
    is a non-persistent buffer, as flax keeps no leaf for it."""

    def __init__(self, n_keypoints: int, learned_beta: bool = False, initial_beta: float = 25.0,
                 size_mult: float = 1.0):
        super().__init__()
        beta = torch.full((n_keypoints,), float(initial_beta))
        if learned_beta:
            self.beta = nn.Parameter(beta)
        else:
            self.register_buffer("beta", beta, persistent=False)
        self.size_mult = size_mult

    def forward(self, heatmaps: torch.Tensor) -> torch.Tensor:
        return soft_argmax(heatmaps, self.beta, size_mult=self.size_mult)
