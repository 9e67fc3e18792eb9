"""DreamHourglass with the upsample decoder (vgg-Q), in NCHW.

Port of ``dream_tpu/models/hourglass.py:142-220`` for the configuration on
the port's main path: a VGG19-style encoder in five down blocks with 2x2
floor max-pools between them, two nearest-x2 upsample blocks, and a
64 -> 32 -> n_keypoints belief head, giving quarter-resolution belief maps.
Submodules carry the flax tree's names (``down1.conv0``,
``upsample4.conv1``, ``head.conv2``), so ``checkpoint.params_from_flax``
output loads with ``load_state_dict(strict=True)``.  The skip, deconv,
full-output, multistage and soft-argmax variants are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.layers import conv3x3, max_pool_torch, upsample_nearest


class _VggDownBlock(nn.Module):
    """n_convs x (3x3 conv + ReLU)."""

    def __init__(self, in_channels: int, features: int, n_convs: int):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"conv{i}", conv3x3(in_channels if i == 0 else features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class _UpsampleBlock(nn.Module):
    """Nearest x2, conv + ReLU, conv: no trailing ReLU, as the reference
    (reference dream/models.py:690-710)."""

    def __init__(self, in_channels: int, mid_features: int, out_features: int):
        super().__init__()
        self.conv0 = conv3x3(in_channels, mid_features)
        self.conv1 = conv3x3(mid_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x, 2)
        return self.conv1(F.relu(self.conv0(x)))


class _BeliefHead(nn.Module):
    """64 -> 64 -> 32 -> n_keypoints belief head (reference dream/models.py:736-747)."""

    def __init__(self, n_keypoints: int):
        super().__init__()
        self.conv0 = conv3x3(64, 64)
        self.conv1 = conv3x3(64, 32)
        self.conv2 = conv3x3(32, n_keypoints)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        return self.conv2(x)


class DreamHourglass(nn.Module):
    """Single-stage hourglass belief-map regressor, upsample decoder.

    Input ``[B, n_image_input_channels, H, W]``; output ``[B, n_keypoints,
    (H//16)*4, (W//16)*4]`` float32 belief maps.
    """

    def __init__(self, n_keypoints: int, n_image_input_channels: int = 3):
        super().__init__()
        self.n_keypoints = n_keypoints
        self.down1 = _VggDownBlock(n_image_input_channels, 64, 2)
        self.down2 = _VggDownBlock(64, 128, 2)
        self.down3 = _VggDownBlock(128, 256, 4)
        self.down4 = _VggDownBlock(256, 512, 4)
        self.down5 = _VggDownBlock(512, 512, 4)
        self.upsample4 = _UpsampleBlock(512, 256, 256)
        self.upsample3 = _UpsampleBlock(256, 128, 64)
        self.head = _BeliefHead(n_keypoints)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down1(x)
        x = self.down2(max_pool_torch(x))
        x = self.down3(max_pool_torch(x))
        x = self.down4(max_pool_torch(x))
        x = self.down5(max_pool_torch(x))
        y = self.upsample3(self.upsample4(x))
        return self.head(y)
