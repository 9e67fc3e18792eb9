"""DopeNetworkBelief: the CPM-style cascaded belief network, in NCHW.

Port of ``dream_tpu/models/dope.py`` (reference dream/models.py:158-347):
VGG19's features through conv4_2 (1/8 resolution), two adapter convs
(512 -> 256 -> 128), then up to six cascaded CPM stages.  Stage 1 runs 3x3
convs and a 128 -> 512 1x1 expansion; stages 2-6 run 7x7 convs on
``cat([previous belief, features])``.  ``stage_out`` truncates the cascade,
and the forward returns every stage's output, last stage last.  Float32,
flax ``nn.Conv``'s initial values; submodules carry the flax tree's names
(``vgg.conv3_2``, ``stage4.conv_mid1``), so ``checkpoint.params_from_flax``
output loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.layers import Conv2d, init_module_, max_pool_torch


def _conv(in_channels: int, features: int, kernel: int) -> Conv2d:
    return Conv2d(in_channels, features, kernel, padding=kernel // 2)


class _VggFeatures(nn.Module):
    """VGG19 features[0:23] + the 512 -> 256 -> 128 adapter (``:34-53``)."""

    BLOCKS = ((1, (64, 64)), (2, (128, 128)), (3, (256, 256, 256, 256)), (4, (512, 512)))

    def __init__(self):
        super().__init__()
        in_channels = 3
        for block, widths in self.BLOCKS:
            for i, f in enumerate(widths):
                self.add_module(f"conv{block}_{i}", _conv(in_channels, f, 3))
                in_channels = f
        self.adapt0 = _conv(512, 256, 3)
        self.adapt1 = _conv(256, 128, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block, widths in self.BLOCKS:
            for i in range(len(widths)):
                x = F.relu(getattr(self, f"conv{block}_{i}")(x))
            if block < 4:
                x = max_pool_torch(x)
        return F.relu(self.adapt1(F.relu(self.adapt0(x))))


class _CpmStage(nn.Module):
    """One CPM refinement stage (``:56-75``)."""

    def __init__(self, in_channels: int, out_channels: int, first: bool):
        super().__init__()
        kernel = 3 if first else 7
        self.n_mid = 2 if first else 4
        self.conv_in = _conv(in_channels, 128, kernel)
        for i in range(self.n_mid):
            self.add_module(f"conv_mid{i}", _conv(128, 128, kernel))
        expand = 512 if first else 128
        self.conv_expand = _conv(128, expand, 1)
        self.conv_out = _conv(expand, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for i in range(self.n_mid):
            x = getattr(self, f"conv_mid{i}")(F.relu(x))
        x = F.relu(self.conv_expand(F.relu(x)))
        return self.conv_out(x)


class DopeNetworkBelief(nn.Module):
    """``[B, 3, H, W]`` -> the list of ``stage_out`` belief maps ``[B,
    n_keypoints, H/8, W/8]`` (``:78-91``)."""

    def __init__(self, n_keypoints: int = 7, stage_out: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 1 <= stage_out <= 6:
            raise ValueError(f"stage_out must be 1 to 6, got {stage_out}")
        self.stage_out = stage_out
        self.vgg = _VggFeatures()
        self.stage1 = _CpmStage(128, n_keypoints, first=True)
        for s in range(2, stage_out + 1):
            self.add_module(f"stage{s}", _CpmStage(128 + n_keypoints, n_keypoints, first=False))
        init_module_(self, generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = self.vgg(x)
        out = self.stage1(features)
        outputs = [out]
        for s in range(2, self.stage_out + 1):
            out = getattr(self, f"stage{s}")(torch.cat([out, features], dim=1))
            outputs.append(out)
        return outputs
