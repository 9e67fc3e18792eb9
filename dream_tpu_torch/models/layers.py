"""Layer primitives with the JAX package's arithmetic, in NCHW.

Port of the parts of ``dream_tpu/models/layers.py`` that vgg-Q uses:
floor-mode max pooling, exact nearest upsampling and the 3x3 same-pad conv.
Convolutions, pools and upsamples are cuDNN/torch calls, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def max_pool_torch(x: torch.Tensor, window: int = 2, stride: int | None = None,
                   padding: int = 0) -> torch.Tensor:
    """MaxPool2d with ceil_mode=False (floor), as ``layers.max_pool_torch``."""
    return F.max_pool2d(x, window, stride or window, padding, ceil_mode=False)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Exact nearest-neighbour upsample by an integer factor."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def conv3x3(in_channels: int, out_channels: int) -> nn.Conv2d:
    """3x3 stride-1 pad-1 conv (flax ``padding=((1, 1), (1, 1))``)."""
    return nn.Conv2d(in_channels, out_channels, kernel_size=3, stride=1, padding=1)
