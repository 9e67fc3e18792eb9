"""vgg-Q int8 inference: the conv stack as a chain of int8 convs.

Port of ``dream_tpu/models/vgg_int8_deploy.py`` (``supports`` ``:130-142``,
``vgg_q_int8_infer`` ``:145-297``).  From the normalized net input:

1. prologue: ``down1`` (both convs, bias, ReLU) and the 2x2 max-pool in
   bf16 whatever the compute dtype, then one quantization at
   ``down2.conv0``'s calibrated scale;
2. chain: the 19 convs of :data:`CHAIN` (``down2.conv0`` to ``head.conv0``)
   through :func:`dream_tpu_torch.ops.conv_int8.conv3x3_int8_ohwi` (the
   CUDA kernel on the card), int8 NHWC in and out, with an int8 2x2 max-pool
   before ``down3``-``down5`` and an int8 2x nearest upsample before
   ``upsample4`` and ``upsample3`` (:data:`PRE`); each link's epilogue
   folds its dequantization and the next conv's quantization into
   ``k = s_x * s_w / s_out`` and ``b = bias / s_out`` (:func:`chain_scales`),
   valid because pooling and nearest upsampling commute with a monotone
   quantization; the last link's consumer is ``head.conv1``;
3. head: ``head.conv1`` as an exact int8 conv outside the kernel
   (``conv3x3_int32_plain``) with the dequantizing epilogue
   ``relu(acc * (s_x1 * s_w1) + b1)`` cast to the compute dtype, then
   ``head.conv2`` in the compute dtype.

Weights and calibrated amax come as the float model's state dict (OIHW)
and the dict of :func:`dream_tpu_torch.models.quant.calibrate`.
:func:`quantize_chain` quantizes and folds them once, into the kernel's
OHWI weight layout;
:func:`run_int8_chain` runs a batch through the result;
:func:`vgg_q_int8_infer` does both, with the JAX function's arguments.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dream_tpu_torch.models.quant import activation_scale, quantize_activations, quantize_weights
from dream_tpu_torch.ops.conv_int8 import conv3x3_int8_ohwi, conv3x3_int8_plain, conv3x3_int32_plain

CHAIN_BACKENDS = ("auto", "plain")

# (block, conv, relu after) in forward order; the consumer of each link is
# the next, and of the last, head.conv1.
CHAIN = [
    ("down2", "conv0", True),
    ("down2", "conv1", True),
    ("down3", "conv0", True),
    ("down3", "conv1", True),
    ("down3", "conv2", True),
    ("down3", "conv3", True),
    ("down4", "conv0", True),
    ("down4", "conv1", True),
    ("down4", "conv2", True),
    ("down4", "conv3", True),
    ("down5", "conv0", True),
    ("down5", "conv1", True),
    ("down5", "conv2", True),
    ("down5", "conv3", True),
    ("upsample4", "conv0", True),
    ("upsample4", "conv1", False),  # _UpsampleBlock has no trailing ReLU
    ("upsample3", "conv0", True),
    ("upsample3", "conv1", False),
    ("head", "conv0", True),
]
# What runs on the int8 activation before the named conv.
PRE = {
    ("down3", "conv0"): "pool",
    ("down4", "conv0"): "pool",
    ("down5", "conv0"): "pool",
    ("upsample4", "conv0"): "up",
    ("upsample3", "conv0"): "up",
}


class Link(NamedTuple):
    pre: Optional[str]
    w_q: torch.Tensor  # int8 OHWI [Co, 3, 3, Ci]
    k: torch.Tensor  # f32 [Co]
    b: torch.Tensor  # f32 [Co]
    relu: bool


class Int8Chain(NamedTuple):
    """Everything :func:`run_int8_chain` needs, quantized and folded."""

    down1: List[torch.Tensor]  # conv0 weight, bias, conv1 weight, bias (float32 OIHW)
    amax_in: torch.Tensor  # down2.conv0's calibrated input amax
    links: List[Link]
    head1_w_q: torch.Tensor  # int8 OHWI
    head1_scale: torch.Tensor  # s_x1 * s_w1, f32 [32]
    head1_b: torch.Tensor
    head2_w: torch.Tensor  # float32 OIHW
    head2_b: torch.Tensor


def supports(model) -> bool:
    """The chain covers the single-stage upsample-decoder hourglass (vgg-Q:
    quarter-resolution decoder, no skips, no full output, no soft-argmax
    head, a 3-channel input), as ``vgg_int8_deploy.supports`` (``:130-142``)."""
    from dream_tpu_torch.models.hourglass import DreamHourglass

    return (
        isinstance(model, DreamHourglass)
        and not model.deconv_decoder
        and not model.full_output
        and not model.skip_connections
        and not model.internalize_spatial_softmax
        and model.n_image_input_channels == 3
    )


def chain_shapes(batch: int, size: int = 400, n_keypoints: int = 7):
    """(B, H, W, Ci, Co, relu) of each link of :data:`CHAIN` at a
    ``size`` x ``size`` net input: the channels from the model's own
    convs, the map size from ``down1``'s pool and :data:`PRE`."""
    from dream_tpu_torch.models.hourglass import DreamHourglass

    with torch.device("meta"):
        model = DreamHourglass(n_keypoints)
    h = size // 2
    shapes = []
    for block, conv, relu in CHAIN:
        pre = PRE.get((block, conv))
        h = h // 2 if pre == "pool" else h * 2 if pre == "up" else h
        co, ci = getattr(getattr(model, block), conv).weight.shape[:2]
        shapes.append((batch, h, h, ci, co, relu))
    return shapes


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy that never shares the parameter's storage."""
    return t.detach().to(torch.float32, copy=True)


def _ohwi(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW -> contiguous OHWI, the int8 conv kernel's weight layout."""
    return w_q.permute(0, 2, 3, 1).contiguous()


def chain_scales(params: Dict[str, torch.Tensor], qvars: Dict[str, torch.Tensor], idx: int):
    """(int8 OHWI weight, k, b) of link ``idx`` with its consumer's scale
    folded in (``vgg_int8_deploy.py:200-211``)."""
    block, conv, _ = CHAIN[idx]
    name = f"{block}.{conv}"
    w_q, s_w = quantize_weights(params[name + ".weight"])
    consumer = "{}.{}".format(*CHAIN[idx + 1][:2]) if idx + 1 < len(CHAIN) else "head.conv1"
    s_x, s_out = activation_scale(qvars[name]), activation_scale(qvars[consumer])
    k = s_x * s_w / s_out
    b = _f32(params[name + ".bias"]) / s_out
    return _ohwi(w_q), k.contiguous(), b.contiguous()


@torch.no_grad()
def quantize_chain(params: Dict[str, torch.Tensor], qvars: Dict[str, torch.Tensor]) -> Int8Chain:
    """Quantize and fold ``params`` (a DreamHourglass state dict) with the
    calibrated ``qvars`` (amax by module path), on the params' device.  The
    result holds copies: training the model later does not change it."""
    links = []
    for idx, (block, conv, relu) in enumerate(CHAIN):
        w_q, k, b = chain_scales(params, qvars, idx)
        links.append(Link(PRE.get((block, conv)), w_q, k, b, relu))
    w_q1, s_w1 = quantize_weights(params["head.conv1.weight"])
    return Int8Chain(
        down1=[_f32(params[f"down1.conv{i}.{leaf}"])
               for i in range(2) for leaf in ("weight", "bias")],
        amax_in=qvars["down2.conv0"].detach().clone(),
        links=links,
        head1_w_q=_ohwi(w_q1),
        head1_scale=activation_scale(qvars["head.conv1"]) * s_w1,
        head1_b=_f32(params["head.conv1.bias"]),
        head2_w=_f32(params["head.conv2.weight"]),
        head2_b=_f32(params["head.conv2.bias"]),
    )


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 floor-mode max-pool of NHWC ``x`` (exact in any dtype)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NHWC ``x``."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3x3 same-pad conv of NHWC ``x`` by an OIHW weight of its dtype, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def run_int8_chain(chain: Int8Chain, net_in: torch.Tensor,
                   dtype: torch.dtype = torch.float32, backend: str = "auto") -> torch.Tensor:
    """Normalized NHWC f32 ``[B, H, W, 3]`` (H, W multiples of 16) -> f32
    belief maps NHWC ``[B, H/4, W/4, n_keypoints]``.

    ``backend`` picks the chain's convs as ``dream_tpu``'s ``backend``
    argument does (``vgg_int8_deploy.py:145-168``): ``"auto"`` runs the CUDA
    int8 conv kernel for CUDA tensors and the plain version for CPU
    tensors; ``"plain"`` runs the exact plain int32 route on any device,
    which ``torch.export`` can trace (``dream_tpu_torch/export.py``)."""
    if backend not in CHAIN_BACKENDS:
        raise ValueError(f"backend must be one of {CHAIN_BACKENDS}, got {backend!r}")
    conv = conv3x3_int8_ohwi if backend == "auto" else conv3x3_int8_plain
    _, h, w, _ = net_in.shape
    if h % 16 or w % 16:
        raise ValueError(f"the int8 chain takes H and W multiples of 16, got {h}x{w}")
    w0, b0, w1, b1 = chain.down1
    x = net_in.to(torch.bfloat16)
    x = torch.relu(_conv_nhwc(x, w0) + b0.to(torch.bfloat16))
    x = torch.relu(_conv_nhwc(x, w1) + b1.to(torch.bfloat16))
    x_q = quantize_activations(_pool2(x), chain.amax_in)[0].contiguous()

    for link in chain.links:
        if link.pre == "pool":
            x_q = _pool2(x_q).contiguous()
        elif link.pre == "up":
            x_q = _up2(x_q)
        x_q = conv(x_q, link.w_q, link.k, link.b, relu=link.relu)

    acc = conv3x3_int32_plain(x_q, chain.head1_w_q)
    x = torch.relu(acc.to(torch.float32) * chain.head1_scale + chain.head1_b).to(dtype)
    out = _conv_nhwc(x, chain.head2_w) + chain.head2_b.to(dtype)
    return out.to(torch.float32)


def vgg_q_int8_infer(params: Dict[str, torch.Tensor], qvars: Dict[str, torch.Tensor],
                     net_in: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 inference, ``dream_tpu``'s function with its arguments: the
    float state dict, the calibrated amax and the normalized NHWC input ->
    f32 NHWC belief maps."""
    return run_int8_chain(quantize_chain(params, qvars), net_in, dtype)
