"""The int8 conv kernel's tiling, on the CPU.

``csrc/conv_int8_kernel.cu`` picks its tiles in its launch function
(``plan_tiles``) and its blocks walk them in a fixed order; the CUDA kernel
itself runs only on the card.  ``dream_tpu_torch.ops.conv_int8.tile_plan``
and ``tile_origin`` are that plan and that order in Python (the CUDA tests
hold the built library's plan equal to ``tile_plan``).  Here:

- the plan covers every output pixel and channel exactly once, for the 19
  links of vgg-Q's int8 chain at B=16 and for odd shapes, and keeps TMA's
  and the kernel's limits (a tile of at most 128 pixels by 128 channels or
  256 by 64, boxes of at most 256 a side, a k-block width that divides Ci,
  the shared memory a block may have);
- every map of the chain (25, 50, 100 and 200 pixels a side) is cut into
  whole tiles (5 x 25, or 5 x 50 for the 64-channel links) that use at
  least 97% of the tile's rows;
- an emulation in numpy of what the kernel computes tile by tile (each
  tap one box of the activations at the tile's origin shifted by the tap,
  zeros outside the image; the tile's rows past th * tw filled with junk; the
  channel tile's weight rows past Co zeros; only pixels inside the tile
  and the image stored) equals ``dream_tpu``'s
  ``conv3x3_int8_reference`` bit for bit at small odd shapes, with both
  clamps reached.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_tpu.ops import pallas_conv as pc
from dream_tpu_torch.models.vgg_int8_deploy import chain_shapes
from dream_tpu_torch.ops import conv_int8

H100_SMS = 132
ODD_SHAPES = [  # (B, H, W, Ci, Co): H, W not multiples of 5 or 25; Ci of each k-block width; partial channel tiles
    (3, 7, 9, 32, 8), (2, 33, 17, 96, 200), (1, 1, 1, 32, 8), (1, 26, 51, 64, 264),
    (2, 1, 1, 96, 40), (4, 50, 50, 64, 200), (16, 50, 50, 128, 264), (1, 130, 3, 32, 64),
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _coverage(b, h, w, ci, co, sms=H100_SMS):
    plan = conv_int8.tile_plan(b, h, w, ci, co, sms)
    n_tiles_n = -(-co // plan.bn)
    counts = np.zeros((b, h, w, n_tiles_n), np.int32)
    for tile in range(plan.tiles):
        img, y0, x0, n0 = conv_int8.tile_origin(plan, h, w, co, tile)
        assert n0 % plan.bn == 0 and n0 < co
        counts[img, y0:y0 + plan.th, x0:x0 + plan.tw, n0 // plan.bn] += 1
    return plan, counts


@pytest.mark.parametrize("shape", chain_shapes(16) + [s + (True,) for s in ODD_SHAPES],
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_plan_covers_every_output_once(shape):
    b, h, w, ci, co, _ = shape
    plan, counts = _coverage(b, h, w, ci, co)
    assert (counts == 1).all()
    # The channel tiles, n0 = 0, bn, 2bn, ..., cover [0, Co) once.
    assert counts.shape[-1] * plan.bn >= co > (counts.shape[-1] - 1) * plan.bn
    rows = 16384 // plan.bn  # 128 accumulators a consumer thread
    assert plan.bn == (64 if co <= 64 else 128)
    assert plan.th * plan.tw <= rows and plan.th <= min(h, 256) and plan.tw <= min(w, 256)
    assert plan.bk in (32, 64, 128) and ci % plan.bk == 0
    assert plan.stages >= 2 and plan.smem == plan.stages * (rows + plan.bn) * plan.bk + 1024
    assert plan.smem + 4096 <= 232448  # static barriers and scales beside it
    assert plan.blocks == min(plan.tiles, H100_SMS)


def test_chain_maps_are_cut_into_whole_tiles():
    for b, h, w, ci, co, _ in chain_shapes(16):
        plan = conv_int8.tile_plan(b, h, w, ci, co, H100_SMS)
        assert h % plan.th == 0 and w % plan.tw == 0
        assert plan.th * plan.tw >= 0.97 * (16384 // plan.bn)
        assert (plan.th, plan.tw) == ((5, 25) if co > 64 else (5, 50))
        assert plan.tiles == b * (h // plan.th) * (w // plan.tw) * -(-co // plan.bn)


def _emulate_tiles(x_q, w_ohwi, k, bias, relu, rng):
    """What the kernel computes, tile by tile, in numpy."""
    b, h, w, ci = x_q.shape
    co = w_ohwi.shape[0]
    plan = conv_int8.tile_plan(b, h, w, ci, co, H100_SMS)
    out = np.full((b, h, w, co), 99, np.int8)  # every output must be written
    w_rows = w_ohwi.reshape(co, 9 * ci).astype(np.int64)
    lo = 0.0 if relu else -127.0
    for tile in range(plan.tiles):
        img, y0, x0, n0 = conv_int8.tile_origin(plan, h, w, co, tile)
        rows = 16384 // plan.bn
        acc = np.zeros((rows, plan.bn), np.int64)
        # weight rows past Co: zeros (TMA's fill)
        wt = np.zeros((plan.bn, 9 * ci), np.int64)
        wt[:min(plan.bn, co - n0)] = w_rows[n0:n0 + plan.bn]
        for kc in range(ci // plan.bk):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a = rng.randint(-127, 128, (rows, plan.bk)).astype(np.int64)  # junk past th * tw
                for i in range(plan.th * plan.tw):
                    y, x = y0 + i // plan.tw + dy - 1, x0 + i % plan.tw + dx - 1
                    inside = 0 <= y < h and 0 <= x < w
                    a[i] = x_q[img, y, x, kc * plan.bk:(kc + 1) * plan.bk] if inside else 0
                col = tap * ci + kc * plan.bk
                acc += a @ wt[:, col:col + plan.bk].T
        for i in range(plan.th * plan.tw):
            y, x = y0 + i // plan.tw, x0 + i % plan.tw
            if y >= h or x >= w:
                continue
            n = min(plan.bn, co - n0)
            yv = acc[i, :n].astype(np.float32) * k[n0:n0 + n] + bias[n0:n0 + n]
            if relu:
                yv = np.maximum(yv, np.float32(0))
            out[img, y, x, n0:n0 + n] = np.clip(np.round(yv), lo, 127).astype(np.int8)
    return out


@pytest.mark.parametrize("shape,relu", [
    ((2, 7, 9, 32, 8), False), ((1, 12, 11, 96, 72), True), ((1, 6, 26, 64, 264), False),
    ((1, 1, 1, 32, 40), True), ((1, 11, 30, 128, 16), True),
])
def test_tiled_emulation_matches_jax_reference(shape, relu):
    b, h, w, ci, co = shape
    rng = np.random.RandomState(sum(shape))
    x_q = rng.randint(-127, 128, (b, h, w, ci)).astype(np.int8)
    w_ohwi = rng.randint(-127, 128, (co, 3, 3, ci)).astype(np.int8)
    k = (rng.uniform(0.5, 1.5, co) / (np.sqrt(9 * ci) * 80.0)).astype(np.float32)
    bias = rng.uniform(-30, 30, co).astype(np.float32)
    got = _emulate_tiles(x_q, w_ohwi, k, bias, relu, rng)
    want = np.asarray(pc.conv3x3_int8_reference(
        jnp.asarray(x_q), jnp.asarray(w_ohwi.transpose(1, 2, 3, 0)), jnp.asarray(k),
        jnp.asarray(bias), relu=relu))
    np.testing.assert_array_equal(got, want)
    # and the port's plain version, the kernel's yardstick on the card
    plain = conv_int8.conv3x3_int8_plain(*(torch.from_numpy(a) for a in (x_q, w_ohwi, k, bias)), relu)
    np.testing.assert_array_equal(plain.numpy(), want)
    if got.size >= 2000:
        assert (got == 127).any() and (got == (0 if relu else -127)).any()
