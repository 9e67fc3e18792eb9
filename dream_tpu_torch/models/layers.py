"""Layer primitives with the JAX package's arithmetic, in NCHW.

Port of ``dream_tpu/models/layers.py``: floor-mode max pooling, exact
nearest upsampling, the 3x3 same-pad conv, the 1x1 conv and
``TorchConvTranspose``; and of ``flax.linen.BatchNorm`` as the ResNets use
it.  Convolutions, pools and upsamples are cuDNN/torch calls, as the JAX
package leaves them to XLA.  Every conv follows flax's dtype rule
(:func:`conv_in_dtype`): parameters stay float32, and with a bfloat16
compute dtype the input, weight and bias are cast to it and the result is
bfloat16.  Convs start from flax ``nn.Conv``'s defaults (:func:`init_conv_`),
not torch's: lecun-normal weights and zero biases; transposed convs from
``TorchConvTranspose``'s (:func:`init_conv_transpose_`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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


def conv_in_dtype(conv: Callable[..., torch.Tensor], x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], dtype: torch.dtype, **kwargs) -> torch.Tensor:
    """``conv(x, weight, bias, **kwargs)`` under flax's dtype rule: input,
    weight and bias are cast to the compute ``dtype`` (a no-op in float32),
    so the result is in ``dtype`` while the parameters stay float32."""
    return conv(x.to(dtype), weight.to(dtype), None if bias is None else bias.to(dtype), **kwargs)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (:func:`conv_in_dtype`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_in_dtype(F.conv2d, x, self.weight, self.bias, self.compute_dtype,
                             stride=self.stride, padding=self.padding)


def conv3x3(in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32) -> Conv2d:
    """3x3 stride-1 pad-1 conv (flax ``padding=((1, 1), (1, 1))``)."""
    return Conv2d(in_channels, out_channels, 3, stride=1, padding=1, dtype=dtype)


def conv1x1(in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32) -> Conv2d:
    """1x1 conv with a bias (``layers.conv1x1``)."""
    return Conv2d(in_channels, out_channels, 1, dtype=dtype)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``ConvTranspose2d(k, stride, padding, output_padding)`` computing in
    ``dtype``, the counterpart of ``layers.TorchConvTranspose``.

    That module applies its HWIO ``kernel`` K to the lhs-dilated input
    without a flip, padded ``k-1-p`` low and ``k-1-p+output_padding`` high;
    ``F.conv_transpose2d`` applies its ``[in, out, kh, kw]`` weight W
    flipped and pads the same way, so ``W = K.flip(0, 1).permute(2, 3, 0,
    1)`` (``checkpoint.params_from_flax`` carries it across).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 2,
                 padding: int = 1, output_padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, output_padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_in_dtype(F.conv_transpose2d, x, self.weight, self.bias, self.compute_dtype,
                             stride=self.stride, padding=self.padding,
                             output_padding=self.output_padding)


# momentum and epsilon of dream_tpu's BatchNorm (torch's momentum 0.1 is
# flax's 0.9 on the running value; dream_tpu/models/resnet_simple.py:22-30).
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


def _channel_affine(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``x * scale + shift`` per channel of NCHW ``x``, computed in float32
    and written in ``dtype``: one pass over ``x`` when no gradient is
    recorded."""
    scale, shift = scale[:, None, None], shift[:, None, None]
    if torch.is_grad_enabled():
        return torch.addcmul(shift, x, scale).to(dtype)
    return torch.addcmul(shift, x, scale, out=torch.empty_like(x, dtype=dtype))


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-channel float32 sum of NCHW ``x``: each plane first, a reduction
    over contiguous memory, then the batch."""
    return x.sum((2, 3), dtype=torch.float32).sum(0)


class _BatchStatsNorm(torch.autograd.Function):
    """Batch-statistics normalisation of NCHW ``x``: the forward of
    ``flax.linen.BatchNorm`` in train mode, and its gradient.  Only ``x``
    and per-channel vectors are kept for the backward pass (a composition
    of torch ops would keep several float32 copies of ``x``).  Returns
    ``(y in dtype, batch mean, biased batch variance)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        count = x.numel() // x.shape[1]
        # E[x] and E[x^2] of x in float32, as flax: the variance below
        # cancels their leading digits, so E[x^2] takes no shortcut (the
        # square of a fused vector norm lost enough digits to quadruple a
        # ResNet gradient's error against a float64 one).
        x32 = x.to(torch.float32)
        mean = _channel_sum(x32) / count
        mean2 = _channel_sum(x32.square()) / count
        del x32
        var = torch.clamp_min(mean2 - mean.square(), 0.0)
        rstd = torch.rsqrt(var + BN_EPSILON)
        scale = rstd * weight
        y = _channel_affine(x, scale, bias - mean * scale, dtype)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad_y, _grad_mean, _grad_var):
        x, weight, mean, rstd = ctx.saved_tensors
        count = x.numel() // x.shape[1]
        g = grad_y  # in the compute dtype; every use below computes in float32
        x_hat = torch.sub(x, mean[:, None, None]).mul_(rstd[:, None, None])
        grad_bias = _channel_sum(g)
        grad_weight = _channel_sum(g * x_hat)
        # grad_x = (g - mean(g) - x_hat * mean(g * x_hat)) * weight * rstd
        rest = torch.addcmul((-grad_bias / count)[:, None, None], x_hat,
                             (-grad_weight / count)[:, None, None], out=x_hat).add_(g)
        grad_x = torch.mul(rest, (weight * rstd)[:, None, None], out=torch.empty_like(x))
        return grad_x, grad_weight, grad_bias, None


class BatchNorm2d(nn.Module):
    """``flax.linen.BatchNorm`` as ``dream_tpu``'s ResNets use it (feature
    axis last there, channels here), with torch's parameter and buffer names.

    In train mode the batch statistics are computed in float32 whatever the
    compute dtype, the variance as ``E[x^2] - E[x]^2`` clipped at 0; the
    running values move as ``0.9 * running + 0.1 * batch``, the running
    variance with the biased batch variance (``nn.BatchNorm2d`` takes the
    unbiased one and momentum 0.1).  In eval mode the running statistics
    normalise.  Either way, with ``s = rsqrt(var + 1e-5) * weight``, ``y = x
    * s + (bias - mean * s)`` in float32 (flax's ``(x - mean) * s + bias``
    with the mean folded into the shift), returned in the compute ``dtype``.
    """

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        """flax's initial values: scale 1, bias 0, running mean 0, variance 1."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = _BatchStatsNorm.apply(x, self.weight, self.bias, self.compute_dtype)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var)
            return y
        scale = torch.rsqrt(self.running_var + BN_EPSILON) * self.weight
        return _channel_affine(x, scale, self.bias - self.running_mean * scale, self.compute_dtype)


# Standard deviation of a unit normal truncated to [-2, 2]: flax divides by it
# so that the truncated draws have the intended standard deviation.
_TRUNCATED_NORMAL_STDDEV = 0.87962566103423978


def _draw_device(generator: Optional[torch.Generator]) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill an OIHW conv weight as ``flax.linen.initializers.lecun_normal()``:
    a normal truncated at 2 standard deviations, with standard deviation
    ``1/sqrt(fan_in)`` after truncation (fan_in = I*kh*kw).  The draws come
    from ``generator`` on its own device (the global CPU generator if None)
    and are copied into ``weight``, so a seed gives the same weights on any
    device.  A weight on the meta device holds no values: nothing is drawn."""
    if weight.is_meta:
        return weight
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STDDEV
    draw = torch.empty(weight.shape, dtype=torch.float32, device=_draw_device(generator))
    torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        return weight.copy_(draw)


def init_conv_(conv: nn.Conv2d, generator: Optional[torch.Generator] = None) -> None:
    """flax ``nn.Conv``'s default init: lecun-normal kernel, zero bias."""
    lecun_normal_(conv.weight, generator)
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()


def init_conv_transpose_(conv: nn.ConvTranspose2d,
                         generator: Optional[torch.Generator] = None) -> None:
    """``TorchConvTranspose``'s init: ``variance_scaling(1/3, "fan_in",
    "uniform")`` on the HWIO kernel, i.e. uniform in ``+-1/sqrt(fan_in)``
    with ``fan_in = kh*kw*in``, and a zero bias.  A ``[in, out, kh, kw]``
    weight has ``in`` first.  Nothing is drawn on the meta device."""
    if conv.weight.is_meta:
        return
    fan_in = conv.weight.shape[0] * conv.weight.shape[2] * conv.weight.shape[3]
    limit = math.sqrt(1.0 / fan_in)
    draw = torch.rand(conv.weight.shape, dtype=torch.float32, device=_draw_device(generator),
                      generator=generator)
    with torch.no_grad():
        conv.weight.copy_(draw * (2.0 * limit) - limit)
        if conv.bias is not None:
            conv.bias.zero_()


def init_module_(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Redraw every conv, transposed conv and BatchNorm of ``model`` with
    flax's initial values, in module order."""
    for module in model.modules():
        if isinstance(module, nn.ConvTranspose2d):
            init_conv_transpose_(module, generator)
        elif isinstance(module, nn.Conv2d):
            init_conv_(module, generator)
        elif isinstance(module, BatchNorm2d):
            module.reset_parameters()
