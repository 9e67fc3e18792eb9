"""DreamHourglass with the upsample decoder (vgg-Q), in NCHW.

Port of ``dream_tpu/models/hourglass.py:142-220`` for the configuration on
the port's main path: a VGG19-style encoder in five down blocks with 2x2
floor max-pools between them, two nearest-x2 upsample blocks, and a
64 -> 32 -> n_keypoints belief head, giving quarter-resolution belief maps.
Submodules carry the flax tree's names (``down1.conv0``,
``upsample4.conv1``, ``head.conv2``), so ``checkpoint.params_from_flax``
output loads with ``load_state_dict(strict=True)``.  Parameters start
from flax's distributions (``layers.init_conv_``), drawn in the order of
the modules from an explicit generator.  The skip, deconv, full-output,
multistage and soft-argmax variants are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.layers import conv3x3, init_conv_, max_pool_torch, upsample_nearest
from dream_tpu_torch.models.quant import QuantConv2d


def _conv3x3(in_channels: int, features: int, quant_mode: Optional[str]) -> QuantConv2d:
    """A quantizable 3x3 conv: ``qat`` under QAT, a plain conv otherwise
    until calibration switches it (``dream_tpu/models/hourglass.py:36-41``)."""
    return QuantConv2d(in_channels, features, mode="qat" if quant_mode == "qat" else "float")


class _VggDownBlock(nn.Module):
    """n_convs x (3x3 conv + ReLU)."""

    def __init__(self, in_channels: int, features: int, n_convs: int,
                 quant_mode: Optional[str] = None):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(
                f"conv{i}", _conv3x3(in_channels if i == 0 else features, features, quant_mode)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class _UpsampleBlock(nn.Module):
    """Nearest x2, conv + ReLU, conv: no trailing ReLU, as the reference
    (reference dream/models.py:690-710)."""

    def __init__(self, in_channels: int, mid_features: int, out_features: int,
                 quant_mode: Optional[str] = None):
        super().__init__()
        self.conv0 = _conv3x3(in_channels, mid_features, quant_mode)
        self.conv1 = _conv3x3(mid_features, out_features, quant_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x, 2)
        return self.conv1(F.relu(self.conv0(x)))


class _BeliefHead(nn.Module):
    """64 -> 64 -> 32 -> n_keypoints belief head (reference dream/models.py:736-747).
    conv2, the belief-map output layer, is never quantized: the peak decoder
    reads its output at subpixel resolution."""

    def __init__(self, n_keypoints: int, quant_mode: Optional[str] = None):
        super().__init__()
        self.conv0 = _conv3x3(64, 64, quant_mode)
        self.conv1 = _conv3x3(64, 32, quant_mode)
        self.conv2 = conv3x3(32, n_keypoints)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        return self.conv2(x)


class DreamHourglass(nn.Module):
    """Single-stage hourglass belief-map regressor, upsample decoder.

    Input ``[B, n_image_input_channels, H, W]``; output ``[B, n_keypoints,
    (H//16)*4, (W//16)*4]`` float32 belief maps.  ``generator`` seeds the
    initial parameters (the global CPU generator if None).  ``quant_mode``
    ``"qat"`` fake-quantizes every conv but ``head.conv2``
    (:class:`~dream_tpu_torch.models.quant.QuantConv2d`); None runs them
    as plain convs.
    """

    def __init__(self, n_keypoints: int, n_image_input_channels: int = 3,
                 generator: Optional[torch.Generator] = None, quant_mode: Optional[str] = None):
        super().__init__()
        if quant_mode not in (None, "qat"):
            raise ValueError(f'quant_mode must be None or "qat", got {quant_mode!r}')
        self.n_keypoints = n_keypoints
        self.n_image_input_channels = n_image_input_channels
        q = quant_mode
        self.down1 = _VggDownBlock(n_image_input_channels, 64, 2, q)
        self.down2 = _VggDownBlock(64, 128, 2, q)
        self.down3 = _VggDownBlock(128, 256, 4, q)
        self.down4 = _VggDownBlock(256, 512, 4, q)
        self.down5 = _VggDownBlock(512, 512, 4, q)
        self.upsample4 = _UpsampleBlock(512, 256, 256, q)
        self.upsample3 = _UpsampleBlock(256, 128, 64, q)
        self.head = _BeliefHead(n_keypoints, q)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Redraw every conv as flax's ``nn.Conv`` defaults, in module order."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                init_conv_(module, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down1(x)
        x = self.down2(max_pool_torch(x))
        x = self.down3(max_pool_torch(x))
        x = self.down4(max_pool_torch(x))
        x = self.down5(max_pool_torch(x))
        y = self.upsample3(self.upsample4(x))
        return self.head(y)
