"""The CUDA kernels (score, warp, int8 conv) against their plain torch
versions, on the card; and the scanned epoch's CUDA graph against its plain
version, the eager loop of the same step.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skips elsewhere.  This file
imports neither jax nor dream_tpu, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from dream_tpu_torch.data.dataset import make_batch_processor
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.data.augment import DEFAULT_AUGMENT, affine_matrices, sample_augment_params
from dream_tpu_torch.models.vgg_int8_deploy import CHAIN, PRE, chain_shapes
from dream_tpu_torch.ops import conv_int8, score_kernel, warp
from dream_tpu_torch.ops.belief_maps import create_belief_maps, peaks_from_belief_maps


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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


# The scanned epoch: a small hourglass (4 key points, 64x64 input) on 12
# frames of 128x96 held on the card, batch 4, three steps an epoch,
# augmentation on (the warp kernel and the generator in the graph), Adam
# under clipping and a warmup-cosine schedule, an EMA.
SCAN_CONFIG = {
    "architecture": {"type": "vgg", "target": "belief_maps", "input_heads": ["image_rgb"],
                     "output_heads": ["belief_maps"], "loss": {"type": "mse"},
                     "image_normalization": {"mean": [0.5] * 3, "stdev": [0.5] * 3},
                     "image_preprocessing": "shrink-and-crop"},
    "manipulator": {"name": "panda", "keypoints": [{"name": f"kp{i}"} for i in range(4)]},
    "training": {"config": {"net_input_resolution": [64, 64], "optimizer": {
        "type": "adam", "learning_rate": 1e-4, "grad_clip_norm": 0.25,
        "schedule": {"type": "cosine", "decay_steps": 20, "warmup_steps": 2}}}},
}


@pytest.fixture
def optimizer():
    """The scanned networks' optimizer; a test parametrizes it."""
    return "adam"


@pytest.fixture
def scan_pair(cuda, monkeypatch, optimizer):
    """Two networks from one start, each scanning, cuDNN deterministic; the
    set and three epochs' index matrices on the card."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = copy.deepcopy(SCAN_CONFIG)
    cfg["training"]["config"]["optimizer"]["type"] = optimizer
    scanned = DreamNetwork(cfg, device=cuda, seed=3)
    eager = copy.deepcopy(scanned)
    for net in (scanned, eager):
        net.enable_ema(0.9)
        net.enable_scanned_training(make_batch_processor(
            (128, 96), (64, 64), (16, 16), "shrink-and-crop", SCAN_CONFIG["architecture"]["image_normalization"],
            augment=True))
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randint(0, 256, (12, 96, 128, 3)).astype(np.uint8)).to(cuda)
    kps = torch.from_numpy(rng.uniform(20, 90, (12, 4, 2)).astype(np.float32)).to(cuda)
    matrices = [torch.from_numpy(rng.permutation(12).reshape(3, 4)).to(cuda) for _ in range(3)]
    return scanned, eager, images, kps, matrices


def _held(net):
    out = {f"model.{k}": v for k, v in net.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in net.ema_params.items()})
    for name, p in net.model.named_parameters():
        out.update({f"adam.{name}.{k}": v for k, v in net.optimizer.state.get(p, {}).items()})
    return out


def _assert_same(scanned, eager, losses_s, losses_e):
    torch.cuda.synchronize()
    assert torch.equal(losses_s, losses_e) and torch.isfinite(losses_s).all()
    a, b = _held(scanned), _held(eager)
    assert set(a) == set(b) and [k for k in a if not torch.equal(a[k], b[k])] == []
    assert scanned.steps == eager.steps
    if isinstance(scanned.optimizer, torch.optim.Adam):
        assert len(a) > 3 * len(list(scanned.model.parameters()))
        assert {int(v) for k, v in a.items() if k.endswith(".step")} == {scanned.steps}
    assert int(scanned.optimizer_state()["1"]["1"]["count"]) == scanned.steps


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_scanned_epochs_equal_the_eager_loop(scan_pair, optimizer):
    """Adam with capturable state, and SGD through ``DeviceSGD``."""
    scanned, eager, images, kps, matrices = scan_pair
    gs, ge = (torch.Generator(device="cuda").manual_seed(5) for _ in range(2))
    start = copy.deepcopy(scanned.model.state_dict())
    losses_s = torch.cat([scanned.train_epoch_raw(gs, images, kps, m) for m in matrices[:2]])
    losses_e = torch.cat([eager.train_epoch_raw_plain(ge, images, kps, m) for m in matrices[:2]])
    _assert_same(scanned, eager, losses_s, losses_e)
    assert scanned.steps == 6
    assert any(not torch.equal(v, start[k]) for k, v in scanned.model.state_dict().items())
    # The generators moved alike: replays drew fresh augmentation.
    assert torch.equal(gs.get_state(), ge.get_state())
    assert len(set(losses_s.tolist())) == 6


@pytest.mark.cuda
def test_load_optimizer_state_captures_again(scan_pair):
    scanned, eager, images, kps, matrices = scan_pair
    gs, ge = (torch.Generator(device="cuda").manual_seed(6) for _ in range(2))
    scanned.train_epoch_raw(gs, images, kps, matrices[0])
    eager.train_epoch_raw_plain(ge, images, kps, matrices[0])
    graph = scanned._epoch_graph
    assert graph is not None
    tree = scanned.optimizer_state()
    for net in (scanned, eager):
        net.load_optimizer_state(tree)
    assert scanned._epoch_graph is None
    losses_s = scanned.train_epoch_raw(gs, images, kps, matrices[1])
    losses_e = eager.train_epoch_raw_plain(ge, images, kps, matrices[1])
    assert scanned._epoch_graph is not None and scanned._epoch_graph is not graph
    _assert_same(scanned, eager, losses_s, losses_e)
    # A later epoch replays the new graph from its first step.
    graph = scanned._epoch_graph
    losses_s = scanned.train_epoch_raw(gs, images, kps, matrices[2])
    losses_e = eager.train_epoch_raw_plain(ge, images, kps, matrices[2])
    assert scanned._epoch_graph is graph
    _assert_same(scanned, eager, losses_s, losses_e)


@pytest.mark.cuda
def test_warp_launches_count_the_replays(scan_pair):
    scanned, _, images, kps, matrices = scan_pair
    g = torch.Generator(device="cuda").manual_seed(7)
    kernel = warp.warp_batch_kernel
    launches, captured = kernel.launches, kernel.captured
    scanned.train_epoch_raw(g, images, kps, matrices[0])  # eager step, capture, two replays
    assert (kernel.launches - launches, kernel.captured - captured) == (3, 1)
    assert scanned._epoch_graph.warp_launches == 1
    launches = kernel.launches
    scanned.train_epoch_raw(g, images, kps, matrices[1])  # three replays
    assert (kernel.launches - launches, kernel.captured - captured) == (3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_card_steps_match_the_cpu_steps(cuda, monkeypatch, optimizer):
    """The card's step (capturable Adam or ``DeviceSGD``, the learning rate
    from the count on the device) against the CPU's, which
    tests/test_torch_train.py, test_torch_cli.py and
    test_torch_scanned_epoch.py hold to optax and dream_tpu, with clipping,
    warmup and cosine, and an EMA, from one start, the models in float64
    (``to_float64``; the maps, the loss, the learning rate and its
    schedule stay float32), TF32 off:

    - two whole ``train_raw`` steps on the same frames, at
      tests/test_torch_train.py's tolerances (losses rtol 1e-5, parameters
      and EMA atol 2e-6);
    - then four steps on the same gradients (``_apply_gradients``: clip,
      learning rate, update, count, EMA), with a resume of both from the
      CPU's optax tree (``load_optimizer_state``) before the last two:
      the learning rate at every step and the counts equal, parameters and
      EMA within atol 2e-6, Adam's moments within rtol 1e-5.

    Whole steps part further on: the two devices' sums round apart, the
    rounding grows with each step's new parameters, and Adam lifts
    gradients near its epsilon to the learning rate's size: on the H100
    the card's Adam parts from the CPU's past these tolerances within a
    few whole steps, capturable or not, so the later steps share their
    gradients."""
    from dream_tpu_torch.parallel.dryrun import to_float64

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = copy.deepcopy(SCAN_CONFIG)
    # SGD at a rate under which the clipped steps move the parameters past
    # the tolerance.
    cfg["training"]["config"]["optimizer"].update(type=optimizer,
                                                  learning_rate=1e-4 if optimizer == "adam" else 1.0)
    nets = {"cpu": DreamNetwork(copy.deepcopy(cfg), device="cpu", seed=3),
            "card": DreamNetwork(copy.deepcopy(cfg), device=cuda, seed=3)}
    nets["card"].model.load_state_dict(nets["cpu"].model.state_dict())
    cpu, card = nets["cpu"], nets["card"]
    start = copy.deepcopy(cpu.model.state_dict())
    rng = np.random.RandomState(8)
    raw = torch.from_numpy(rng.randint(0, 256, (2, 4, 96, 128, 3)).astype(np.uint8))
    kps = torch.from_numpy(rng.uniform(20, 90, (2, 4, 4, 2)).astype(np.float32))
    process = make_batch_processor((128, 96), (64, 64), (16, 16), "shrink-and-crop",
                                   SCAN_CONFIG["architecture"]["image_normalization"], augment=False)
    losses = {}
    for name, net in nets.items():
        to_float64(net)
        net.enable_ema(0.9)
        net.enable_fused_training(process)
        losses[name] = torch.stack([net.train_raw(None, raw[i], kps[i]) for i in range(2)]).cpu()
    np.testing.assert_allclose(losses["card"].numpy(), losses["cpu"].numpy(), rtol=1e-5)

    def assert_close(what):
        theirs = cpu.model.state_dict()
        for k, v in card.model.state_dict().items():
            np.testing.assert_allclose(v.cpu().numpy(), theirs[k].numpy(), atol=2e-6, rtol=0,
                                       err_msg=f"{what}: {k}")
        for k, v in card.ema_params.items():
            np.testing.assert_allclose(v.cpu().numpy(), cpu.ema_params[k].numpy(), atol=2e-6, rtol=0,
                                       err_msg=f"{what}: EMA {k}")

    assert_close("two whole steps")
    # Gradients drawn at two scales: clipped (the global norm far above
    # 0.25) and not (far below).
    for step, scale in zip(range(2, 6), (1e-2, 1e-7, 1e-2, 1e-7)):
        if step == 4:
            tree = cpu.optimizer_state()
            for net in nets.values():
                net.load_optimizer_state(tree)
        grads = [rng.normal(0, scale, p.shape).astype(np.float32) for p in cpu.model.parameters()]
        for net in nets.values():
            for p, g in zip(net.model.parameters(), grads):
                p.grad = torch.from_numpy(g).to(p.device, p.dtype)
            net._apply_gradients()
            net.steps += 1
        assert int(card._count.cpu()) == int(cpu._count) == step + 1
        np.testing.assert_allclose(float(card.optimizer.param_groups[0]["lr"]),
                                   float(cpu.optimizer.param_groups[0]["lr"]), rtol=1e-6,
                                   err_msg=str(step))
    assert_close("four steps on shared gradients")
    # The steps moved the parameters: the comparison is not vacuous.
    assert max(float((cpu.model.state_dict()[k] - v).abs().max()) for k, v in start.items()) > 1e-5
    if optimizer == "adam":
        for p_card, p_cpu in zip(card.model.parameters(), cpu.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(card.optimizer.state[p_card][key].cpu().numpy(),
                                           cpu.optimizer.state[p_cpu][key].numpy(), rtol=1e-5,
                                           atol=0, err_msg=key)
            assert int(card.optimizer.state[p_card]["step"]) == 6
    assert int(card.optimizer_state()["1"]["1"]["count"]) == 6 == int(tree["1"]["1"]["count"]) + 2
