"""ResnetSimple: ResNet-101 trunk + transposed-conv decoder, in NCHW.

Port of ``dream_tpu/models/resnet_simple.py:24-142`` (DREAM's resnet-H and
resnet-F): the torchvision ResNet trunk (conv1/bn1/relu/maxpool and layers
1-4 of bottleneck blocks) followed by four ConvTranspose(k4, s2, p1) +
BatchNorm + ReLU blocks and a 1x1 belief head ("half" resolution), or a
fifth deconv block for ``full``.  Trunk convs have no bias; the transposed
convs and the head have one.

BatchNorm is flax's (``layers.BatchNorm2d``): in train mode it normalises
with the batch statistics and moves the running ones; in eval mode the
running statistics normalise.  Every layer computes in the compute
``dtype`` and the maps return as float32.  Submodule names follow the flax
tree (``layer3.block7.downsample_bn``, ``up2.deconv``, ``head``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    TorchConvTranspose,
    init_module_,
    max_pool_torch,
)


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck block (expansion 4)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.conv1 = Conv2d(in_channels, features, 1, bias=False, dtype=d)
        self.bn1 = BatchNorm2d(features, d)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1, bias=False, dtype=d)
        self.bn2 = BatchNorm2d(features, d)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False, dtype=d)
        self.bn3 = BatchNorm2d(features * 4, d)
        if downsample:
            self.downsample_conv = Conv2d(in_channels, features * 4, 1, stride=stride, bias=False,
                                          dtype=d)
            self.downsample_bn = BatchNorm2d(features * 4, d)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class _ResNetLayer(nn.Module):
    """``n_blocks`` bottlenecks, the first with the stride and the projection."""

    def __init__(self, in_channels: int, features: int, n_blocks: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.n_blocks = n_blocks
        self.block0 = Bottleneck(in_channels, features, stride, downsample=True, dtype=dtype)
        for i in range(1, n_blocks):
            self.add_module(f"block{i}", Bottleneck(features * 4, features, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class _DeconvBNRelu(nn.Module):
    """ConvTranspose(k4, s2, p1) + BatchNorm + ReLU (reference dream/models.py:37-77)."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.deconv = TorchConvTranspose(in_channels, features, 4, stride=2, padding=1, dtype=dtype)
        self.bn = BatchNorm2d(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.deconv(x)))


class ResnetSimple(nn.Module):
    """DREAM-resnet-H ("half") / -F (``full``) belief-map regressor.

    Input ``[B, 3, H, W]``; output ``[B, n_keypoints, h, w]`` float32 belief
    maps (``utils.resolutions.resnet_output_resolution``).  ``layers`` sets
    the trunk's depth (ResNet-101 by default); ``generator`` seeds the
    initial parameters as in :class:`~dream_tpu_torch.models.hourglass.DreamHourglass`.
    """

    def __init__(self, n_keypoints: int = 7, full: bool = False,
                 layers: Sequence[int] = (3, 4, 23, 3), dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_keypoints = n_keypoints
        self.full = full
        self.layers = tuple(layers)
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype)
        in_channels = 64
        for i, (features, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}", _ResNetLayer(in_channels, features, self.layers[i],
                                                          stride, dtype))
            in_channels = features * 4
        for i in range(5 if full else 4):
            self.add_module(f"up{i}", _DeconvBNRelu(in_channels, 256, dtype))
            in_channels = 256
        self.head = Conv2d(256, n_keypoints, 1, dtype=dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initial values for every layer, convs drawn in module order."""
        init_module_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = max_pool_torch(x, window=3, stride=2, padding=1)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        for i in range(5 if self.full else 4):
            x = getattr(self, f"up{i}")(x)
        return self.head(x).to(torch.float32)
