"""The yardstick: the card's published peaks, and the operations and bytes the
algorithms need, counted from their shapes whatever implements them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W):
989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of
HBM.  A convolution counts 2 operations a multiply-add: ``2 * B * Cin * Cout *
kh * kw * Hout * Wout`` (a transposed one over its input's size), as
``torch.utils.flop_counter`` counts it; pools, norms and elementwise work count
nothing.  A training step counts three forwards (forward, input gradients,
weight gradients), nothing recomputed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from benchmark.reference.decode import blur_matrix
from benchmark.reference.models import RESNET_LAYERS, VGG_BLOCKS

BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def vgg_forward_flops(n_keypoints: int, net_res: Sequence[int]) -> int:
    """Operations of one frame through the vgg hourglass (upsample decoder)."""
    w, h = net_res
    total, cin = 0, 3
    for i, (c, n) in enumerate(VGG_BLOCKS):
        if i:
            h, w = h // 2, w // 2
        for j in range(n):
            total += _conv(cin if j == 0 else c, c, 3, h, w)
        cin = c
    for a, b, c in ((512, 256, 256), (256, 128, 64)):
        h, w = h * 2, w * 2
        total += _conv(a, b, 3, h, w) + _conv(b, c, 3, h, w)
    return total + _conv(64, 64, 3, h, w) + _conv(64, 32, 3, h, w) + _conv(32, n_keypoints, 3, h, w)


def resnet_forward_flops(n_keypoints: int, net_res: Sequence[int], layers=RESNET_LAYERS) -> int:
    """Operations of one frame through ResNet-H (ResNet trunk, four
    transposed-conv blocks, 1x1 head)."""
    def down(d):
        return (d - 1) // 2 + 1

    w, h = down(net_res[0]), down(net_res[1])
    total = _conv(3, 64, 7, h, w)
    h, w = down(h), down(w)
    cin = 64
    for i, (features, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        for b in range(n_blocks):
            h_in, w_in = h, w
            if b == 0 and i > 0:
                h, w = down(h), down(w)
            total += _conv(cin, features, 1, h_in, w_in) + _conv(features, features, 3, h, w)
            total += _conv(features, features * 4, 1, h, w)
            if b == 0:
                total += _conv(cin, features * 4, 1, h, w)
            cin = features * 4
    for _ in range(4):
        total += _conv(cin, 256, 4, h, w)  # a transposed conv counts over its input
        h, w, cin = h * 2, w * 2, 256
    return total + _conv(256, n_keypoints, 1, h, w)


def forward_flops(arch: str, n_keypoints: int, net_res: Sequence[int], layers=RESNET_LAYERS) -> int:
    if arch == "vgg":
        return vgg_forward_flops(n_keypoints, net_res)
    return resnet_forward_flops(n_keypoints, net_res, layers)


def train_step_flops(arch: str, n_keypoints: int, net_res: Sequence[int], batch: int,
                     layers=RESNET_LAYERS) -> int:
    return 3 * batch * forward_flops(arch, n_keypoints, net_res, layers)


def warp_bound_ms(n: int, h: int, w: int, c: int) -> float:
    """Least time of the augmentation warp on ``[n, h, w, c]`` float32 images:
    each input value read once, each output value written once, the ``[n, 6]``
    inverse affines read; ~30 operations a pixel for coordinates, fold and
    weights, 11 a channel for the taps."""
    t_bytes = (2 * n * h * w * c * 4 + n * 6 * 4) / HBM_BYTES_PER_S
    t_ops = n * h * w * (30 + 11 * c) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3


def score_bound_ms(n: int, h: int, w: int) -> float:
    """Least time of the peak decode's map-sized half on ``n`` float32 maps of
    ``h x w``: each map read once, the scored map and the peak count written
    once, the blur's 25-tap tables read; 2 operations a blur tap taken (the
    sigma-3 blur's taps that fall inside the map, each row and column)."""
    t_bytes = (n * h * w * 4 * 2 + n * 4 + (h + w) * 25 * 4) / HBM_BYTES_PER_S
    taps_h, taps_w = (int(np.count_nonzero(blur_matrix(d))) for d in (h, w))
    t_ops = n * 2 * (taps_h * w + taps_w * h) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3
