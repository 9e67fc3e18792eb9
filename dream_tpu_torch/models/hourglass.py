"""DreamHourglass and DreamHourglassMultiStage, in NCHW.

Port of ``dream_tpu/models/hourglass.py``: a VGG19-style encoder in five
down blocks with 2x2 floor max-pools between them, then either the
upsample decoder (nearest x2 + convs: quarter resolution, vgg-Q; or full
resolution with ``full_output``) or the transposed-conv decoder (full
resolution, ``deconv_decoder``: vgg-F), optional additive skip
connections, and a 64 -> 32 -> n_keypoints belief head, optionally
followed by the soft-argmax head (``internalize_spatial_softmax``: a
learned or fixed ``beta`` and
:func:`dream_tpu_torch.ops.spatial_softmax.soft_argmax`).  The multistage
model chains hourglasses, each later stage taking the image concatenated
with the previous stage's maps.

Every block computes in the compute ``dtype`` (float32 or bfloat16, flax's
rule, ``layers.conv_in_dtype``): the input is cast to it and the belief maps
return as float32.  Submodules carry the flax tree's names
(``down1.conv0``, ``deconv4.deconv``, ``stage2.upsample4.conv1``), so
``checkpoint.params_from_flax`` output loads with
``load_state_dict(strict=True)``.  Parameters start from flax's
distributions (``layers.init_module_``), drawn in module order from an
explicit generator.  ``quant_mode`` sets the mode of every quantizable
conv (:class:`~dream_tpu_torch.models.quant.QuantConv2d`): ``qat`` for
quantization-aware training, ``calibrate`` and ``int8`` for post-training
quantization, None for plain convs (``dream_tpu/models/hourglass.py:36-43``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.layers import (
    TorchConvTranspose,
    conv3x3,
    init_module_,
    max_pool_torch,
    upsample_nearest,
)
from dream_tpu_torch.models.quant import QuantConv2d
from dream_tpu_torch.ops.spatial_softmax import soft_argmax

HOURGLASS_QUANT_MODES = (None, "qat", "calibrate", "int8")


def _conv3x3(in_channels: int, features: int, dtype: torch.dtype,
             quant_mode: Optional[str]) -> QuantConv2d:
    """A quantizable 3x3 conv in ``quant_mode``, a plain conv for None
    (``dream_tpu/models/hourglass.py:36-41``)."""
    return QuantConv2d(in_channels, features, mode=quant_mode or "float", dtype=dtype)


class _VggDownBlock(nn.Module):
    """n_convs x (3x3 conv + ReLU)."""

    def __init__(self, in_channels: int, features: int, n_convs: int, dtype: torch.dtype,
                 quant_mode: Optional[str] = None):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(
                f"conv{i}",
                _conv3x3(in_channels if i == 0 else features, features, dtype, quant_mode),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class _DeconvBlock(nn.Module):
    """ConvTranspose(k3, s2, p1, op1) + ReLU [+ 3x3 conv + ReLU]
    (``dream_tpu/models/hourglass.py:61-82``)."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype, with_conv: bool = True):
        super().__init__()
        self.deconv = TorchConvTranspose(in_channels, features, 3, stride=2, padding=1,
                                         output_padding=1, dtype=dtype)
        self.conv = conv3x3(features, features, dtype) if with_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.deconv(x))
        return F.relu(self.conv(x)) if self.conv is not None else x


class _UpsampleBlock(nn.Module):
    """Nearest x2, conv + ReLU, conv: no trailing ReLU, as the reference
    (reference dream/models.py:690-710)."""

    def __init__(self, in_channels: int, mid_features: int, out_features: int, dtype: torch.dtype,
                 quant_mode: Optional[str] = None):
        super().__init__()
        self.conv0 = _conv3x3(in_channels, mid_features, dtype, quant_mode)
        self.conv1 = _conv3x3(mid_features, out_features, dtype, quant_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x, 2)
        return self.conv1(F.relu(self.conv0(x)))


class _UpsampleBlockFull(nn.Module):
    """Nearest x2 + (conv + ReLU) x2, the full-output decoder's blocks
    (``dream_tpu/models/hourglass.py:101-121``)."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype,
                 quant_mode: Optional[str] = None):
        super().__init__()
        self.conv0 = _conv3x3(in_channels, features, dtype, quant_mode)
        self.conv1 = _conv3x3(features, features, dtype, quant_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x, 2)
        return F.relu(self.conv1(F.relu(self.conv0(x))))


class _BeliefHead(nn.Module):
    """64 -> 64 -> 32 -> n_keypoints belief head (reference dream/models.py:736-747).
    conv2, the belief-map output layer, is never quantized: the peak decoder
    reads its output at subpixel resolution.  The maps return in float32."""

    def __init__(self, n_keypoints: int, dtype: torch.dtype, quant_mode: Optional[str] = None):
        super().__init__()
        self.conv0 = _conv3x3(64, 64, dtype, quant_mode)
        self.conv1 = _conv3x3(64, 32, dtype, quant_mode)
        self.conv2 = conv3x3(32, n_keypoints, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        return self.conv2(x).to(torch.float32)


class DreamHourglass(nn.Module):
    """Single-stage hourglass belief-map regressor.

    Input ``[B, n_image_input_channels, H, W]``; output ``[B, n_keypoints,
    h, w]`` float32 belief maps, ``h = (H//16)*4`` with the upsample decoder
    and ``(H//16)*16`` with the deconv or full-output one; with
    ``internalize_spatial_softmax``, the list ``[maps, keypoints [B,
    n_keypoints, 2]]``, the keypoints the soft-argmax of the maps under
    ``beta`` (a parameter when ``learned_beta``, else fixed at
    ``initial_beta``; ``dream_tpu/models/hourglass.py:207-219``).
    ``generator`` seeds the initial parameters (the global CPU generator if
    None); ``dtype`` is the compute dtype.  ``quant_mode`` is the mode of
    every quantizable conv, which is every conv but ``head.conv2`` and the
    deconv decoder's (vgg-F's), which stay float as in the reference.
    """

    def __init__(self, n_keypoints: int, n_image_input_channels: int = 3,
                 generator: Optional[torch.Generator] = None, quant_mode: Optional[str] = None,
                 skip_connections: bool = False, deconv_decoder: bool = False,
                 full_output: bool = False, dtype: torch.dtype = torch.float32,
                 internalize_spatial_softmax: bool = False, learned_beta: bool = True,
                 initial_beta: float = 1.0):
        super().__init__()
        if quant_mode not in HOURGLASS_QUANT_MODES:
            raise ValueError(f"quant_mode must be one of {HOURGLASS_QUANT_MODES}, got {quant_mode!r}")
        self.n_keypoints = n_keypoints
        self.n_image_input_channels = n_image_input_channels
        self.skip_connections = skip_connections
        self.deconv_decoder = deconv_decoder
        self.full_output = full_output
        self.dtype = dtype
        q, d = quant_mode, dtype
        self.down1 = _VggDownBlock(n_image_input_channels, 64, 2, d, q)
        self.down2 = _VggDownBlock(64, 128, 2, d, q)
        self.down3 = _VggDownBlock(128, 256, 4, d, q)
        self.down4 = _VggDownBlock(256, 512, 4, d, q)
        self.down5 = _VggDownBlock(512, 512, 4, d, q)
        if deconv_decoder:
            self.deconv4 = _DeconvBlock(512, 256, d)
            self.deconv3 = _DeconvBlock(256, 128, d)
            self.deconv2 = _DeconvBlock(128, 64, d)
            self.deconv1 = _DeconvBlock(64, 64, d, with_conv=False)
        else:
            self.upsample4 = _UpsampleBlock(512, 256, 256, d, q)
            self.upsample3 = _UpsampleBlock(256, 128, 64, d, q)
            if full_output:
                self.upsample2 = _UpsampleBlockFull(64, 64, d, q)
                self.upsample1 = _UpsampleBlockFull(64, 64, d, q)
        self.head = _BeliefHead(n_keypoints, d, q)
        self.internalize_spatial_softmax = internalize_spatial_softmax
        self.initial_beta = float(initial_beta)
        if internalize_spatial_softmax:
            beta = torch.full((n_keypoints,), self.initial_beta)
            if learned_beta:
                self.beta = nn.Parameter(beta)
            else:  # flax keeps no leaf for a fixed beta
                self.register_buffer("beta", beta, persistent=False)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Redraw every conv with flax's defaults, in module order; ``beta``
        back to ``initial_beta``."""
        init_module_(self, generator)
        self.reset_buffers()

    def reset_buffers(self) -> None:
        """``beta`` back to ``initial_beta`` (a fixed one is a buffer no
        state dict holds)."""
        if self.internalize_spatial_softmax:
            with torch.no_grad():
                self.beta.fill_(self.initial_beta)

    def forward(self, x: torch.Tensor):
        skip = self.skip_connections
        x_0_1 = self.down1(x.to(self.dtype))
        x_0_1_d = max_pool_torch(x_0_1)
        x_0_2_d = max_pool_torch(self.down2(x_0_1_d))
        x_0_3_d = max_pool_torch(self.down3(x_0_2_d))
        x_0_4_d = max_pool_torch(self.down4(x_0_3_d))
        x_0_5 = self.down5(x_0_4_d)
        y = x_0_5 + x_0_4_d if skip else x_0_5
        if self.deconv_decoder:
            y = self.deconv4(y)
            y = self.deconv3(y + x_0_3_d if skip else y)
            y = self.deconv2(y + x_0_2_d if skip else y)
            y = self.deconv1(y + x_0_1_d if skip else y)
            y = y + x_0_1 if skip else y
        else:
            y = self.upsample4(y)
            y = self.upsample3(y + x_0_3_d if skip else y)
            if self.full_output:
                y = self.upsample1(self.upsample2(y))
        belief = self.head(y)
        if not self.internalize_spatial_softmax:
            return belief
        return [belief, soft_argmax(belief, self.beta)]


class DreamHourglassMultiStage(nn.Module):
    """1-6 chained hourglasses, ``stage1`` to ``stageN``
    (``dream_tpu/models/hourglass.py:223-275``).

    Later stages take ``cat([image, previous maps])`` on the channel axis,
    the maps nearest-x4 upsampled to the input's size unless the decoder is
    deconv or full-output.  Returns the list of the stages' float32 maps,
    last stage last.  With ``internalize_spatial_softmax`` each stage
    carries its own ``beta`` and computes its keypoints, and the cascade
    passes its maps alone on, as the reference does (``:263-274``).
    """

    def __init__(self, n_keypoints: int, n_stages: int = 2, n_image_input_channels: int = 3,
                 generator: Optional[torch.Generator] = None, quant_mode: Optional[str] = None,
                 skip_connections: bool = False, deconv_decoder: bool = False,
                 full_output: bool = False, dtype: torch.dtype = torch.float32,
                 internalize_spatial_softmax: bool = False, learned_beta: bool = True,
                 initial_beta: float = 1.0):
        super().__init__()
        if not 1 <= n_stages <= 6:
            raise ValueError("DreamHourglassMultiStage supports 1 to 6 stages.")
        self.n_stages = n_stages
        self.upsample_previous = not (deconv_decoder or full_output)
        for stage in range(n_stages):
            channels = n_image_input_channels + (n_keypoints if stage else 0)
            # Each stage draws from ``generator`` in turn: module order.
            self.add_module(f"stage{stage + 1}", DreamHourglass(
                n_keypoints, channels, generator=generator, quant_mode=quant_mode,
                skip_connections=skip_connections, deconv_decoder=deconv_decoder,
                full_output=full_output, dtype=dtype,
                internalize_spatial_softmax=internalize_spatial_softmax,
                learned_beta=learned_beta, initial_beta=initial_beta,
            ))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for stage in range(self.n_stages):
            getattr(self, f"stage{stage + 1}").reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs: List[torch.Tensor] = []
        for stage in range(self.n_stages):
            if stage == 0:
                stage_in = x
            else:
                prev = upsample_nearest(outputs[-1], 4) if self.upsample_previous else outputs[-1]
                stage_in = torch.cat([x, prev], dim=1)
            out = getattr(self, f"stage{stage + 1}")(stage_in)
            outputs.append(out[0] if isinstance(out, list) else out)
        return outputs
