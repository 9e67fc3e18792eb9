"""Quantization of the vgg-Q conv stack: int8 weights and activations.

Port of the vgg part of ``dream_tpu/models/quant.py``:

- weights: per output channel, symmetric, ``s_w = max(max|W|, 1e-12) / 127``
  (:func:`quantize_weights`, ``:76-81``; OIHW here, where the JAX package
  reduces HWIO);
- activations: per tensor, symmetric, from a calibrated ``act_amax``
  (:func:`quantize_activations`, ``:84-87``);
- :class:`QuantConv2d`, a 3x3 conv whose parameters are ``nn.Conv2d``'s (so
  every checkpoint loads unchanged) with the modes of ``QuantConv``
  (``:104-165``): ``float`` (a plain conv), ``calibrate`` (a plain conv that
  records ``act_amax = max(act_amax, max|x|)`` of its input) and ``qat``
  (quantization-aware training: weights per channel and activations by the
  batch's own amax are fake-quantized through a straight-through round,
  the scales detached, and the integer-valued arrays contracted in float32).
- :func:`calibrate`: ``act_amax`` of every quantizable conv over a list of
  batches, as ``enable_int8_inference``'s calibration pass computes it.

The ``int8`` mode of ``QuantConv`` and ``QuantConvTranspose`` are not
ported: only the resnet and deconv int8 graphs use them.  vgg-Q's int8
graph is :mod:`dream_tpu_torch.models.vgg_int8_deploy`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

QUANT_MODES = ("float", "calibrate", "qat")


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` as ``minimum(maximum(x, lo), hi)``: at a bound the
    gradient splits in half, as jax's does for ties."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def quantize_weights(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW weight -> (int8 OIHW weight, f32 ``[O]`` scales), per output channel."""
    w32 = weight.to(torch.float32)
    s_w = torch.clamp_min(w32.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    w_q = torch.clamp(torch.round(w32 / s_w[:, None, None, None]), -127.0, 127.0)
    return w_q.to(torch.int8), s_w


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax.to(torch.float32), 1e-12) / 127.0


def quantize_activations(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 ``x``, f32 scale) at the per-tensor scale ``max(amax, 1e-12) / 127``."""
    s_x = activation_scale(amax)
    x_q = torch.clamp(torch.round(x.to(torch.float32) / s_x), -127.0, 127.0)
    return x_q.to(torch.int8), s_x


class QuantConv2d(nn.Conv2d):
    """3x3 stride-1 pad-1 conv with the ``float``/``calibrate``/``qat`` modes.

    ``act_amax`` is a non-persistent buffer, so state dicts hold the
    parameters alone, as the flax ``params`` collection does; the
    calibrated values travel as their own dict (:func:`calibrate`,
    ``checkpoint.quant_from_flax``).
    """

    def __init__(self, in_channels: int, out_channels: int, mode: str = "float"):
        super().__init__(in_channels, out_channels, kernel_size=3, stride=1, padding=1)
        self.mode = mode
        self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}; expected one of {QUANT_MODES}")
        if self.mode == "calibrate":
            with torch.no_grad():
                self.act_amax.copy_(torch.maximum(self.act_amax, x.abs().amax().to(torch.float32)))
        if self.mode != "qat":
            return super().forward(x)
        w32 = self.weight.to(torch.float32)
        s_w = torch.clamp_min(w32.detach().abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
        w_q = _clip(ste_round(w32 / s_w[:, None, None, None]), -127.0, 127.0)
        x32 = x.to(torch.float32)
        s_x = torch.clamp_min(x32.detach().abs().amax(), 1e-12) / 127.0
        x_q = _clip(ste_round(x32 / s_x), -127.0, 127.0)
        y = F.conv2d(x_q, w_q, padding=1) * (s_x * s_w)[None, :, None, None]
        return y + self.bias.to(torch.float32)[None, :, None, None]


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run ``model`` over NCHW ``batches`` with every quantizable conv in
    ``calibrate`` mode from ``act_amax = 0``; returns the amax of every
    input each conv saw, by module path.  The convs' modes are restored."""
    convs = {name: m for name, m in model.named_modules() if isinstance(m, QuantConv2d)}
    modes = {name: conv.mode for name, conv in convs.items()}
    was_training = model.training
    model.eval()
    n_frames = 0
    try:
        for conv in convs.values():
            conv.mode = "calibrate"
            conv.act_amax.zero_()
        for batch in batches:
            model(batch)
            n_frames += int(batch.shape[0])
    finally:
        for name, conv in convs.items():
            conv.mode = modes[name]
        model.train(was_training)
    if n_frames == 0:
        raise ValueError("int8 calibration needs at least one batch")
    return {name: conv.act_amax.clone() for name, conv in convs.items()}
