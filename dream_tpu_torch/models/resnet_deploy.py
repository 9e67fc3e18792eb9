"""Deploy-time ResnetSimple: BatchNorm folded into the convs, int8-quantizable.

Port of ``dream_tpu/models/resnet_deploy.py``.  For inference the affine
BatchNorm transform folds exactly into the conv before it:

    BN(conv(x, W)) = conv(x, W * s) + (beta - mean * s),
    s = scale / sqrt(var + eps)     (per output channel)

:func:`fold_batchnorm_resnet` maps a ResnetSimple state dict (parameters
and running statistics, ``models/layers.py`` ``BatchNorm2d``) to the state
dict of :class:`ResnetSimpleDeploy`, the same topology with biased convs and
no BatchNorm, folding in float64 and rounding once to float32 as the JAX
package does (``:37-95``).  The deploy model in ``float`` mode tracks the
source model in eval mode; ``calibrate`` records each quantizable conv's
input amax; ``int8`` quantizes every conv and transposed conv (the 7x7
stride-2 stem, the bottlenecks' 1x1 and 3x3, the 4x4 stride-2 upsamplers)
except the 1x1 belief ``head``, which stays in the compute dtype.  Module
names follow the flax tree (``layer3.block7.downsample_conv``,
``up2_deconv``, ``head``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.layers import BN_EPSILON, Conv2d, max_pool_torch
from dream_tpu_torch.models.quant import QuantConv2d, QuantConvTranspose2d

DEPLOY_MODES = ("float", "calibrate", "int8")


def _bn_scale(state: Dict[str, torch.Tensor], bn: str) -> torch.Tensor:
    return state[bn + ".weight"].double() / torch.sqrt(state[bn + ".running_var"].double() + BN_EPSILON)


def _fold(state: Dict[str, torch.Tensor], conv: str, bn: str) -> Dict[str, torch.Tensor]:
    """One BatchNorm folded into the bias-free conv before it (``_fold``, ``:37-49``)."""
    s = _bn_scale(state, bn)
    weight = state[conv + ".weight"].double() * s[:, None, None, None]
    bias = state[bn + ".bias"].double() - state[bn + ".running_mean"].double() * s
    return {"weight": weight.float(), "bias": bias.float()}


@torch.no_grad()
def fold_batchnorm_resnet(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """ResnetSimple state dict (parameters + running statistics) ->
    ResnetSimpleDeploy state dict, float32 on the state's device
    (``fold_batchnorm_resnet``, ``:52-94``)."""
    state = {k: v.detach() for k, v in state.items()}
    folded = {"conv1": _fold(state, "conv1", "bn1")}
    layers = sorted({k.split(".")[0] for k in state if k.startswith("layer")})
    for layer in layers:
        blocks = sorted({k.split(".")[1] for k in state if k.startswith(layer + ".")},
                        key=lambda b: int(b.removeprefix("block")))
        for block in blocks:
            prefix = f"{layer}.{block}."
            for i in (1, 2, 3):
                folded[f"{prefix}conv{i}"] = _fold(state, f"{prefix}conv{i}", f"{prefix}bn{i}")
            if prefix + "downsample_conv.weight" in state:
                folded[prefix + "downsample_conv"] = _fold(state, prefix + "downsample_conv",
                                                           prefix + "downsample_bn")
    ups = sorted({k.split(".")[0] for k in state if k.startswith("up")})
    for up in ups:
        # A transposed conv's weight is [in, out, kh, kw]: out is dim 1.
        s = _bn_scale(state, f"{up}.bn")
        weight = state[f"{up}.deconv.weight"].double() * s[None, :, None, None]
        dc_bias = state[f"{up}.deconv.bias"].double()
        bias = state[f"{up}.bn.bias"].double() + (dc_bias - state[f"{up}.bn.running_mean"].double()) * s
        folded[f"{up}_deconv"] = {"weight": weight.float(), "bias": bias.float()}
    folded["head"] = {"weight": state["head.weight"].clone(), "bias": state["head.bias"].clone()}
    return {f"{module}.{leaf}": t for module, leaves in folded.items() for leaf, t in leaves.items()}


class _BottleneckDeploy(nn.Module):
    """The bottleneck with its BatchNorms folded; the residual add runs in
    the compute dtype (``:97-129``)."""

    def __init__(self, in_channels: int, features: int, stride: int, downsample: bool,
                 mode: str, dtype: torch.dtype):
        super().__init__()
        self.conv1 = QuantConv2d(in_channels, features, 1, padding=0, mode=mode, dtype=dtype)
        self.conv2 = QuantConv2d(features, features, 3, stride=stride, padding=1, mode=mode,
                                 dtype=dtype)
        self.conv3 = QuantConv2d(features, features * 4, 1, padding=0, mode=mode, dtype=dtype)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = QuantConv2d(in_channels, features * 4, 1, stride=stride,
                                               padding=0, mode=mode, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        identity = self.downsample_conv(x) if self.downsample else x
        return F.relu(out + identity)


class _ResNetLayerDeploy(nn.Module):
    def __init__(self, in_channels: int, features: int, n_blocks: int, stride: int, mode: str,
                 dtype: torch.dtype):
        super().__init__()
        self.n_blocks = n_blocks
        self.block0 = _BottleneckDeploy(in_channels, features, stride, True, mode, dtype)
        for i in range(1, n_blocks):
            self.add_module(f"block{i}", _BottleneckDeploy(features * 4, features, 1, False, mode,
                                                           dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResnetSimpleDeploy(nn.Module):
    """Inference-only ResnetSimple with folded BatchNorm and quantizable
    convs (``:153-202``).  ``mode`` is the mode of every quantizable conv
    (:data:`DEPLOY_MODES`); the parameters come from
    :func:`fold_batchnorm_resnet` (``load_state_dict``).  Input ``[B, 3, H,
    W]``; output float32 belief maps, as ResnetSimple's."""

    def __init__(self, n_keypoints: int = 7, full: bool = False,
                 layers: Sequence[int] = (3, 4, 23, 3), dtype: torch.dtype = torch.float32,
                 mode: str = "float"):
        super().__init__()
        if mode not in DEPLOY_MODES:
            raise ValueError(f"mode must be one of {DEPLOY_MODES}, got {mode!r}")
        self.full = full
        self.layers = tuple(layers)
        self.dtype = dtype
        self.conv1 = QuantConv2d(3, 64, 7, stride=2, padding=3, mode=mode, dtype=dtype)
        in_channels = 64
        for i, (features, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}", _ResNetLayerDeploy(in_channels, features, self.layers[i],
                                                                stride, mode, dtype))
            in_channels = features * 4
        for i in range(5 if full else 4):
            self.add_module(f"up{i}_deconv", QuantConvTranspose2d(in_channels, 256, 4, stride=2,
                                                                  padding=1, mode=mode, dtype=dtype))
            in_channels = 256
        # The 1x1 belief head stays in the compute dtype: the peak decoder
        # reads its output at subpixel resolution.
        self.head = Conv2d(in_channels, n_keypoints, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x.to(self.dtype)))
        x = max_pool_torch(x, window=3, stride=2, padding=1)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        for i in range(5 if self.full else 4):
            x = F.relu(getattr(self, f"up{i}_deconv")(x))
        return self.head(x).to(torch.float32)
