"""Quantization of the conv stacks: int8 weights and activations.

Port of ``dream_tpu/models/quant.py``:

- weights: per output channel, symmetric, ``s_w = max(max|W|, 1e-12) / 127``
  (:func:`quantize_weights`, ``:76-81``; OIHW here, where the JAX package
  reduces HWIO);
- activations: per tensor, symmetric, from a calibrated ``act_amax``
  (:func:`quantize_activations`, ``:84-87``);
- :class:`QuantConv2d` (``QuantConv``, ``:168-200``), a conv with
  ``nn.Conv2d``'s parameters, kernel size, stride and padding, and
  :class:`QuantConvTranspose2d` (``QuantConvTranspose``, ``:203-235``), a
  ``ConvTranspose2d(k, s, p)`` with ``layers.TorchConvTranspose``'s
  parameters, so every checkpoint loads unchanged.  Their modes are
  ``_QuantConvBase._run``'s (``:104-166``): ``float`` (a plain conv in the
  compute dtype), ``calibrate`` (a plain conv that records ``act_amax =
  max(act_amax, max|x|)`` of its input), ``int8`` (weights and the input
  quantized, the exact int32 accumulation of
  :mod:`dream_tpu_torch.ops.conv_int32`, then ``acc * (s_x * s_w) + bias``
  in float32, cast to the compute dtype) and, for :class:`QuantConv2d`,
  ``qat`` (quantization-aware training: weights per channel and activations
  by the batch's own amax are fake-quantized through a straight-through
  round, the scales detached, and the integer-valued arrays contracted in
  float32).
- :func:`calibrate`: ``act_amax`` of every quantizable conv over a list of
  batches, as ``enable_int8_inference``'s calibration pass computes it;
  :func:`set_int8` switches a calibrated model to ``int8``.

vgg-Q's int8 graph of chained int8 convs is
:mod:`dream_tpu_torch.models.vgg_int8_deploy`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.layers import Conv2d, TorchConvTranspose
from dream_tpu_torch.ops.conv_int32 import conv2d_int32, conv_transpose2d_int32

QUANT_MODES = ("float", "calibrate", "int8", "qat")


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` as ``minimum(maximum(x, lo), hi)``: at a bound the
    gradient splits in half, as jax's does for ties."""
    def bound(v: float) -> torch.Tensor:
        # Filled on the device: no host-to-device copy, which a CUDA graph
        # of a QAT step could not hold.
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def quantize_weights(weight: torch.Tensor, out_dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv weight -> (int8 weight, f32 ``[O]`` scales), per output channel
    (dimension ``out_dim``: 0 for OIHW, 1 for a transposed conv's
    ``[in, out, kh, kw]``)."""
    w32 = weight.to(torch.float32)
    others = tuple(d for d in range(w32.dim()) if d != out_dim)
    s_w = torch.clamp_min(w32.abs().amax(dim=others), 1e-12) / 127.0
    shape = [1] * w32.dim()
    shape[out_dim] = -1
    w_q = torch.clamp(torch.round(w32 / s_w.reshape(shape)), -127.0, 127.0)
    return w_q.to(torch.int8), s_w


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax.to(torch.float32), 1e-12) / 127.0


def quantize_activations(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 ``x``, f32 scale) at the per-tensor scale ``max(amax, 1e-12) / 127``."""
    s_x = activation_scale(amax)
    x_q = torch.clamp(torch.round(x.to(torch.float32) / s_x), -127.0, 127.0)
    return x_q.to(torch.int8), s_x


class _QuantMixin:
    """The mode handling both quantizable convs share.  ``act_amax`` is a
    non-persistent buffer, so state dicts hold the parameters alone, as the
    flax ``params`` collection does; the calibrated values travel as their
    own dict (:func:`calibrate`, ``checkpoint.quant_from_flax``)."""

    modes = QUANT_MODES

    def _init_quant(self, mode: str) -> None:
        self.mode = mode
        self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32), persistent=False)

    def reset_buffers(self) -> None:
        """``act_amax`` back to 0, as built (no state dict holds it)."""
        with torch.no_grad():
            self.act_amax.zero_()

    def _quant_forward(self, x: torch.Tensor, out_dim: int) -> Optional[torch.Tensor]:
        """``None`` where the float conv runs (``float``, ``calibrate``),
        else the ``int8`` result, from the subclass's exact ``_int32``
        accumulator of the int8 input and weights."""
        if self.mode not in self.modes:
            raise ValueError(f"unknown quant mode {self.mode!r}; expected one of {self.modes}")
        if self.mode == "calibrate":
            with torch.no_grad():
                self.act_amax.copy_(torch.maximum(self.act_amax, x.abs().amax().to(torch.float32)))
        if self.mode != "int8":
            return None
        x_q, s_x = quantize_activations(x, self.act_amax)
        w_q, s_w = quantize_weights(self.weight, out_dim)
        acc = self._int32(x_q, w_q)
        y = acc.to(torch.float32) * (s_x * s_w)[:, None, None] + self.bias.to(torch.float32)[:, None, None]
        return y.to(self.compute_dtype)


class QuantConv2d(_QuantMixin, Conv2d):
    """A conv (any kernel size, stride and padding) with the ``float``,
    ``calibrate``, ``int8`` and ``qat`` modes.  Every mode returns the
    compute ``dtype``: ``float`` and ``calibrate`` convolve in it, ``int8``
    and ``qat`` compute in float32 and cast the result
    (``dream_tpu/models/quant.py:104-166``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, mode: str = "float", dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         dtype=dtype)
        self._init_quant(mode)

    def _int32(self, x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
        return conv2d_int32(x_q, w_q, self.stride[0], self.padding[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode != "qat":
            y = self._quant_forward(x, 0)
            return super().forward(x) if y is None else y
        w32 = self.weight.to(torch.float32)
        s_w = torch.clamp_min(w32.detach().abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
        w_q = _clip(ste_round(w32 / s_w[:, None, None, None]), -127.0, 127.0)
        x32 = x.to(torch.float32)
        s_x = torch.clamp_min(x32.detach().abs().amax(), 1e-12) / 127.0
        x_q = _clip(ste_round(x32 / s_x), -127.0, 127.0)
        y = F.conv2d(x_q, w_q, stride=self.stride, padding=self.padding) * (s_x * s_w)[None, :, None, None]
        return (y + self.bias.to(torch.float32)[None, :, None, None]).to(self.compute_dtype)


class QuantConvTranspose2d(_QuantMixin, TorchConvTranspose):
    """``ConvTranspose2d(k, s, p)`` with the ``float``, ``calibrate`` and
    ``int8`` modes.  The zeros a transposed conv inserts are exact in the
    symmetric int8 domain, so quantization commutes with them
    (``dream_tpu/models/quant.py:203-235``)."""

    modes = ("float", "calibrate", "int8")

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1, mode: str = "float", dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         dtype=dtype)
        self._init_quant(mode)

    def _int32(self, x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
        return conv_transpose2d_int32(x_q, w_q, self.stride[0], self.padding[0],
                                      self.output_padding[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._quant_forward(x, 1)
        return super().forward(x) if y is None else y


def quant_convs(model: nn.Module) -> Dict[str, _QuantMixin]:
    """Every quantizable conv of ``model``, by module path."""
    return {name: m for name, m in model.named_modules() if isinstance(m, _QuantMixin)}


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run ``model`` over NCHW ``batches`` with every quantizable conv in
    ``calibrate`` mode from ``act_amax = 0``; returns the amax of every
    input each conv saw, by module path.  The convs' modes are restored."""
    convs = quant_convs(model)
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


@torch.no_grad()
def set_int8(model: nn.Module, qvars: Dict[str, torch.Tensor]) -> nn.Module:
    """Switch every quantizable conv of ``model`` to ``int8`` with its
    calibrated amax from ``qvars`` (by module path, as :func:`calibrate`
    returns them); every conv must have one.  Returns ``model`` in eval mode."""
    convs = quant_convs(model)
    if set(convs) != set(qvars):
        raise ValueError(f"the amax dict names {sorted(set(qvars) ^ set(convs))} that the model's "
                         "quantizable convs do not match")
    for name, conv in convs.items():
        conv.act_amax.copy_(qvars[name])
        conv.mode = "int8"
    return model.eval()
