"""Layer primitives with the JAX package's arithmetic, in NCHW.

Port of the parts of ``dream_tpu/models/layers.py`` that vgg-Q uses:
floor-mode max pooling, exact nearest upsampling and the 3x3 same-pad conv.
Convolutions, pools and upsamples are cuDNN/torch calls, as the JAX package
leaves them to XLA.  Convs start from flax ``nn.Conv``'s defaults
(:func:`init_conv_`), not torch's: lecun-normal weights and zero biases.
"""

from __future__ import annotations

import math
from typing import Optional

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


# Standard deviation of a unit normal truncated to [-2, 2]: flax divides by it
# so that the truncated draws have the intended standard deviation.
_TRUNCATED_NORMAL_STDDEV = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill an OIHW conv weight as ``flax.linen.initializers.lecun_normal()``:
    a normal truncated at 2 standard deviations, with standard deviation
    ``1/sqrt(fan_in)`` after truncation (fan_in = I*kh*kw).  The draws come
    from ``generator`` on its own device (the global CPU generator if None)
    and are copied into ``weight``, so a seed gives the same weights on any
    device."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STDDEV
    device = generator.device if generator is not None else torch.device("cpu")
    draw = torch.empty(weight.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        return weight.copy_(draw)


def init_conv_(conv: nn.Conv2d, generator: Optional[torch.Generator] = None) -> None:
    """flax ``nn.Conv``'s default init: lecun-normal kernel, zero bias."""
    lecun_normal_(conv.weight, generator)
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()
