"""The CUDA kernels (score, warp, int8 conv) against their plain torch
versions, on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skips elsewhere.  This file
imports neither jax nor dream_tpu, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from dream_tpu_torch.data.augment import DEFAULT_AUGMENT, affine_matrices, sample_augment_params
from dream_tpu_torch.models.vgg_int8_deploy import CHAIN, PRE, chain_shapes
from dream_tpu_torch.ops import conv_int8, score_kernel, warp
from dream_tpu_torch.ops.belief_maps import create_belief_maps, peaks_from_belief_maps


def _maps(rng, n, h, w):
    maps = np.zeros((n, h, w), np.float32)
    for _ in range(3):
        kp = torch.from_numpy(rng.uniform([0, 0], [w, h], size=(n, 1, 2)).astype(np.float32))
        amp = rng.uniform(0.2, 1.0, size=(n, 1, 1)).astype(np.float32)
        maps += amp * create_belief_maps(kp, (w, h))[:, 0].numpy()
    return maps + rng.rand(n, h, w).astype(np.float32) * 0.004


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(112, 100, 100), (14, 400, 400), (21, 37, 53), (3, 5, 300),
                                   (5, 12, 12), (2, 401, 399), (2, 40, 1936)])
def test_score_kernel_matches_plain(cuda, shape):
    maps = torch.from_numpy(_maps(np.random.RandomState(6), *shape)).to(cuda)
    before = score_kernel.score_maps_kernel.launches
    scored, count = score_kernel.score_maps_kernel(maps)
    ref_scored, ref_count = score_kernel.score_maps_plain(maps)
    torch.cuda.synchronize()
    assert score_kernel.score_maps_kernel.launches == before + 1
    assert torch.equal(count, ref_count)
    assert torch.equal(scored, ref_scored)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows,cluster", [
    ((112, 100, 100), None, 2), ((112, 100, 100), None, 4), ((6, 100, 100), 9, 4),
    ((4, 37, 53), 5, 3), ((3, 400, 400), None, 1), ((5, 60, 80), 20, None),
])
def test_score_kernel_plans_match_plain(cuda, shape, rows, cluster):
    """Other cuts than the default: clusters of 2-4 blocks a map, blocks that
    walk several bands (bands of 9 and 5 rows), one block a 400x400 map."""
    n, h, w = shape
    if rows is None:
        plan = score_kernel.score_plan(h, w, cluster=cluster)
    else:
        bands = -(-h // rows)
        plan = score_kernel.ScorePlan(rows, min(cluster or 1, bands), bands, 4 if w % 4 == 0 else 1,
                                      score_kernel.smem_bytes(rows, h, w))
    maps = torch.from_numpy(_maps(np.random.RandomState(5), *shape)).to(cuda)
    scored, count = score_kernel.score_maps_kernel(maps, plan)
    ref_scored, ref_count = score_kernel.score_maps_plain(maps)
    torch.cuda.synchronize()
    assert torch.equal(count, ref_count)
    assert torch.equal(scored, ref_scored)


@pytest.mark.cuda
def test_decode_on_cuda_goes_through_the_kernel(cuda):
    maps = torch.from_numpy(_maps(np.random.RandomState(7), 14, 100, 100)).to(cuda)
    before = score_kernel.score_maps_kernel.launches
    peaks = peaks_from_belief_maps(maps.reshape(2, 7, 100, 100), 0.4395)
    assert score_kernel.score_maps_kernel.launches == before + 1
    ref = peaks_from_belief_maps(maps.cpu().reshape(2, 7, 100, 100), 0.4395)
    assert torch.equal(peaks["count"].cpu(), ref["count"])
    valid = ref["valid"]
    torch.testing.assert_close(peaks["coords"].cpu()[valid], ref["coords"][valid], atol=1e-4, rtol=0)
    torch.testing.assert_close(peaks["scores"].cpu()[valid], ref["scores"][valid], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(ValueError):
        score_kernel.score_maps_kernel(torch.zeros(2, 10, 10, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        score_kernel.score_maps_kernel(torch.zeros(2, 10, 10, device=cuda).transpose(1, 2))


def _warp_inputs(rng, b, h, w, c, kind):
    images = torch.from_numpy((rng.rand(b, h, w, c) * 255).astype(np.float32))
    n = torch.ones(b, dtype=torch.bool)
    if kind == "identity":
        affines = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]]).expand(b, 2, 3).contiguous()
    elif kind == "random":
        cfg = DEFAULT_AUGMENT._replace(p_shift_scale_rotate=1.0)
        affines = sample_augment_params(torch.Generator().manual_seed(b), b, h, w, cfg).affines
    elif kind == "extreme":  # max rotation, scale-down and shift: folds on every side
        f = torch.ones(b)
        affines = affine_matrices(n, 15 * f, 0.9 * f, 0.0625 * w * f, -0.0625 * h * f, h, w)
    else:  # far outside the augmentation's range: folds more than once
        f = torch.ones(b)
        affines = affine_matrices(n, 70 * f, 0.3 * f, 1.7 * w * f, -2.3 * h * f, h, w)
    return images, affines


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "extreme", "multifold", "identity"])
@pytest.mark.parametrize("shape", [(4, 400, 400, 3), (3, 37, 53, 3), (2, 64, 128, 1), (2, 2, 5, 4),
                                   (2, 31, 21, 3), (3, 16, 10, 1), (2, 9, 7, 2)])
def test_warp_kernel_matches_plain(cuda, shape, kind):
    images, affines = _warp_inputs(np.random.RandomState(8), *shape, kind)
    images, affines = images.to(cuda), affines.to(cuda)
    before = warp.warp_batch_kernel.launches
    out = warp.warp_batch_kernel(images, affines)
    ref = warp.warp_batch_plain(images, affines)
    torch.cuda.synchronize()
    assert warp.warp_batch_kernel.launches == before + 1
    if kind == "identity":
        assert torch.equal(out, images)
    # Same rounding order in both: equal to the bit, 2e-3 is the stated bound.
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_warp_batch_on_cuda_goes_through_the_kernel(cuda):
    images, affines = _warp_inputs(np.random.RandomState(9), 2, 48, 40, 3, "random")
    before = warp.warp_batch_kernel.launches
    out = warp.warp_batch(images.to(cuda), affines.to(cuda))
    assert warp.warp_batch_kernel.launches == before + 1
    torch.testing.assert_close(out.cpu(), warp.warp_batch_plain(images, affines), atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_warp_kernel_rejects_bad_inputs(cuda):
    affines = torch.eye(3, device=cuda)[:2].expand(2, 2, 3)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 8, 8, 3, dtype=torch.float64, device=cuda), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 3, 8, 8, device=cuda).permute(0, 2, 3, 1), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 1, 8, 3, device=cuda), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(3, 8, 8, 3, device=cuda), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 8, 8, 3), affines.cpu())


# (B, H, W, Ci, Co, relu) of the 19 links of vgg-Q's int8 chain at a
# 400x400 input, one frame.
CHAIN_SHAPES = chain_shapes(1)


def _int8_case(rng, b, h, w, ci, co, device):
    x_q = torch.from_numpy(rng.randint(-127, 128, (b, h, w, ci)).astype(np.int8)).to(device)
    w_q = torch.from_numpy(rng.randint(-127, 128, (co, 3, 3, ci)).astype(np.int8)).to(device)  # OHWI
    # A scale that spreads the outputs over the whole int8 range, both signs.
    # (a uniform int8 product has a standard deviation of ~5,400).
    k = torch.from_numpy((rng.uniform(0.5, 1.5, co) / (np.sqrt(9 * ci) * 80.0)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-30, 30, co).astype(np.float32))
    return x_q, w_q, k.to(device), bias.to(device)


def test_chain_shapes_follow_the_chain():
    assert len(CHAIN_SHAPES) == len(CHAIN) == 19
    assert [relu for *_, relu in CHAIN_SHAPES] == [relu for *_, relu in CHAIN]
    # down1 leaves 64 channels at 200x200; each link reads what the one
    # before it wrote, pooled or upsampled where PRE says so.
    _, h, _, ci, _, _ = CHAIN_SHAPES[0]
    assert (h, ci) == (200, 64)
    for (block, conv, _), (b, h_in, w_in, ci, _, _), (_, h, _, _, co, _) in zip(
            CHAIN[1:], CHAIN_SHAPES[1:], CHAIN_SHAPES):
        h = {"pool": h // 2, "up": h * 2}.get(PRE.get((block, conv)), h)
        assert (b, h_in, w_in, ci) == (1, h, h, co)
    assert CHAIN_SHAPES[-1][1:5] == (100, 100, 64, 64)
    # 129.0 GOP a frame.
    assert sum(2 * 9 * h * w * ci * co for _, h, w, ci, co, _ in CHAIN_SHAPES) == 129_024_000_000


def _check_conv(cuda, rng, b, h, w, ci, co, relu):
    x_q, w_q, k, bias = _int8_case(rng, b, h, w, ci, co, cuda)
    before = conv_int8.conv3x3_int8_kernel.launches
    out = conv_int8.conv3x3_int8_kernel(x_q, w_q, k, bias, relu)
    ref = conv_int8.conv3x3_int8_plain(x_q, w_q, k, bias, relu)
    torch.cuda.synchronize()
    assert conv_int8.conv3x3_int8_kernel.launches == before + 1
    assert out.dtype == torch.int8 and out.shape == (b, h, w, co)
    assert torch.equal(out, ref), int((out != ref).sum())
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(19))
def test_conv_int8_kernel_matches_plain_at_the_chain_shapes(cuda, index):
    relu = CHAIN_SHAPES[index][-1]
    ref = _check_conv(cuda, np.random.RandomState(index), *CHAIN_SHAPES[index])
    # The data reach both clamps.
    assert int((ref == 127).sum()) > 0 and int((ref == (0 if relu else -127)).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,relu", [
    ((1, 25, 50, 64, 64), True), ((2, 16, 24, 32, 64), False), ((1, 8, 8, 64, 64), True),
    ((3, 7, 9, 32, 8), False), ((2, 1, 1, 96, 40), True), ((1, 33, 17, 32, 200), False),
])
def test_conv_int8_kernel_matches_plain_at_odd_shapes(cuda, shape, relu):
    _check_conv(cuda, np.random.RandomState(sum(shape)), *shape, relu)


# The wgmma kernel's tiling: one link of each map size of the chain at the
# main path's batch; H and W that are not multiples of the 5 x 25 tile;
# Ci of each k-block width (32, 64, 96 -> 32-, 64- and 32-byte swizzle,
# 128 and up -> 128-byte); Co of 8, 40, 200 and 264 (partial channel
# tiles, a partial second one at 264).
NEW_TILING_CASES = [
    ((16, 200, 200, 64, 128), True), ((16, 100, 100, 256, 256), True),
    ((16, 50, 50, 512, 512), True), ((16, 25, 25, 512, 512), True),
    ((3, 7, 9, 32, 8), False), ((2, 33, 17, 96, 200), True), ((2, 1, 1, 64, 40), False),
    ((1, 26, 51, 64, 264), True), ((4, 50, 50, 64, 200), False), ((16, 50, 50, 128, 264), True),
    ((1, 130, 3, 32, 64), False), ((2, 31, 77, 96, 40), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,relu", NEW_TILING_CASES, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_conv_int8_kernel_matches_plain_across_tilings(cuda, shape, relu):
    ref = _check_conv(cuda, np.random.RandomState(sum(shape)), *shape, relu)
    if ref.numel() >= 2000:  # the data reach both clamps
        assert int((ref == 127).sum()) > 0 and int((ref == (0 if relu else -127)).sum()) > 0


@pytest.mark.cuda
def test_conv_int8_plan_of_the_library_is_tile_plan(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape in [s[:5] for s in chain_shapes(16)] + [s for s, _ in NEW_TILING_CASES]:
        for n_sms in (sms, 132, 7):
            assert conv_int8.conv3x3_int8_kernel.plan(*shape, n_sms) == conv_int8.tile_plan(*shape, n_sms)


@pytest.mark.cuda
def test_conv_int8_dispatch_and_two_link_chain(cuda):
    rng = np.random.RandomState(3)
    x_q, w1, k1, b1 = _int8_case(rng, 1, 16, 16, 32, 64, cuda)
    _, w2, k2, b2 = _int8_case(rng, 1, 16, 16, 64, 32, cuda)
    h1, h2 = (w.permute(1, 2, 3, 0) for w in (w1, w2))  # the public HWIO layout
    before = conv_int8.conv3x3_int8_kernel.launches
    got = conv_int8.conv3x3_int8(conv_int8.conv3x3_int8(x_q, h1, k1, b1), h2, k2, b2)
    got_ohwi = conv_int8.conv3x3_int8_ohwi(conv_int8.conv3x3_int8_ohwi(x_q, w1, k1, b1), w2, k2, b2)
    assert conv_int8.conv3x3_int8_kernel.launches == before + 4
    cpu = [t.cpu() for t in (x_q, h1, k1, b1, h2, k2, b2)]
    mid = conv_int8.conv3x3_int8(*cpu[:4])
    want = conv_int8.conv3x3_int8(mid, *cpu[4:])
    assert conv_int8.conv3x3_int8_kernel.launches == before + 4  # CPU tensors: the plain version
    assert torch.equal(got.cpu(), want) and torch.equal(got_ohwi.cpu(), want)


@pytest.mark.cuda
def test_conv_int8_kernel_rejects_bad_inputs(cuda):
    x_q, w_q, k, bias = _int8_case(np.random.RandomState(4), 1, 8, 8, 32, 64, cuda)
    kernel = conv_int8.conv3x3_int8_kernel
    with pytest.raises(ValueError):  # wrong dtype
        kernel(x_q.to(torch.int32), w_q, k, bias)
    with pytest.raises(ValueError):
        kernel(x_q, w_q, k.double(), bias)
    with pytest.raises(ValueError):  # not contiguous
        kernel(x_q.transpose(1, 2), w_q, k, bias)
    with pytest.raises(ValueError):  # CPU and CUDA mixed
        kernel(x_q, w_q.cpu(), k, bias)
    with pytest.raises(ValueError):  # CPU tensors
        kernel(*(t.cpu() for t in (x_q, w_q, k, bias)))
    with pytest.raises(ValueError):  # Ci not a multiple of 32
        kernel(x_q[..., :16].contiguous(), w_q[..., :16].contiguous(), k, bias)
    with pytest.raises(ValueError):  # mismatched channels
        kernel(x_q, w_q[..., :16].contiguous(), k, bias)


@pytest.mark.cuda
def test_launch_counts_hold_across_threads(cuda):
    """The pose server launches the score and int8 conv kernels from its
    handler threads: no launch is lost from the counts."""
    import sys
    import threading

    maps = torch.from_numpy(_maps(np.random.RandomState(8), 7, 100, 100)).to(cuda)
    x_q = torch.randint(-127, 128, (1, 25, 25, 64), dtype=torch.int8, device=cuda)
    w_q = torch.randint(-127, 128, (64, 3, 3, 64), dtype=torch.int8, device=cuda)
    k = torch.full((64,), 1e-4, device=cuda)
    b = torch.zeros(64, device=cuda)
    score, conv = score_kernel.score_maps_kernel, conv_int8.conv3x3_int8_kernel
    before = (score.launches, conv.launches)
    n_threads, calls = 24, 20

    def launch():
        for _ in range(calls):
            score(maps)
            conv(x_q, w_q, k, b)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert (score.launches - before[0], conv.launches - before[1]) == (n_threads * calls,) * 2
