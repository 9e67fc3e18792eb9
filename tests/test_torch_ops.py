"""Port ops against dream_tpu on the CPU: resolutions, coordinate affines,
preprocessing, belief maps, the score kernel's plain version and the peak
decode.

Inputs come from numpy seeds and go through both packages; dream_tpu runs as
its own tests run it (XLA decode, or the Pallas kernel with interpret=True).
The CUDA kernel itself runs only on the card (tests/test_torch_kernel_cuda.py);
here its tiling is checked through a numpy emulation of the same index
arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dream_tpu.ops import belief_maps as jbm
from dream_tpu.ops import coords as jcoords
from dream_tpu.ops import image_proc as jimg
from dream_tpu.ops.pallas_kernels import peaks_from_belief_maps_pallas
from dream_tpu.utils import resolutions as jres

from dream_tpu_torch.ops import belief_maps as tbm
from dream_tpu_torch.ops import coords as tcoords
from dream_tpu_torch.ops import image_proc as timg
from dream_tpu_torch.ops import score_kernel
from dream_tpu_torch.utils import resolutions as tres

MODES = ["none", "resize", "shrink", "shrink-and-crop"]


@pytest.mark.parametrize("raw", [(640, 480), (480, 640), (400, 400), (1280, 720)])
def test_resolution_algebra_matches(raw):
    ref = (400, 400)
    for mode in MODES:
        assert tres.resolution_after_preprocessing(raw, ref, mode) == \
            jres.resolution_after_preprocessing(raw, ref, mode)
    assert tres.shrink_and_crop_resolution(raw, ref) == jres.shrink_and_crop_resolution(raw, ref)
    for full in (False, True):
        assert tres.vgg_output_resolution(raw, full_output=full) == \
            jres.vgg_output_resolution(raw, full_output=full)
        assert tres.resnet_output_resolution(raw, full=full) == \
            jres.resnet_output_resolution(raw, full=full)


@pytest.mark.parametrize("mode", MODES)
def test_coordinate_affines_match(mode):
    rng = np.random.RandomState(1)
    kp = rng.uniform(-50, 700, size=(3, 7, 2)).astype(np.float32)
    raw, netin, netout = (640, 480), (400, 400), (100, 100)
    if mode == "shrink":
        netin = jres.resolution_after_preprocessing(raw, netin, mode)
    pairs = [
        (tcoords.convert_keypoints_to_raw_from_netin(kp, netin, raw, mode),
         jcoords.convert_keypoints_to_raw_from_netin(kp, netin, raw, mode)),
        (tcoords.convert_keypoints_to_netin_from_raw(kp, raw, netin, mode),
         jcoords.convert_keypoints_to_netin_from_raw(kp, raw, netin, mode)),
        (tcoords.convert_keypoints_to_netin_from_netout(kp, netout, netin),
         jcoords.convert_keypoints_to_netin_from_netout(kp, netout, netin)),
        (tcoords.convert_keypoints_to_netout_from_netin(kp, netin, netout),
         jcoords.convert_keypoints_to_netout_from_netin(kp, netin, netout)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-6, atol=1e-4)
    # A torch tensor stays a tensor, in its dtype.
    affine = tcoords.affine_raw_from_netin(netin, raw, mode)
    out = affine(torch.from_numpy(kp))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), affine.apply_numpy(kp), rtol=1e-6, atol=1e-4)
    inv = affine.invert().compose(affine)
    np.testing.assert_allclose(inv.apply_numpy(kp), kp, atol=1e-3)


def _frames(n=2, h=480, w=640, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["shrink-and-crop", "resize", "none"])
def test_preprocessing_matches_jax(mode):
    """640x480 uint8 -> 400x400, atol 1e-3 on the 0-255 scale."""
    img = _frames()
    ref = np.asarray(jimg.preprocess_images(img, (400, 400), mode))
    ours = timg.preprocess_images(torch.from_numpy(img), (400, 400), mode).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=0)


def test_preprocessing_shrink_mode():
    """640x480 -> 533x400.  Against the float64 product of the same weight
    matrices the port is within 1e-3; jax's float32 CPU einsum is further
    off that exact value (~5e-3 on the 0-255 scale), so it is held to 1e-2."""
    img = _frames(n=1)
    ours = timg.preprocess_images(torch.from_numpy(img), (400, 400), "shrink").numpy()
    wh = timg.resize_weight_matrix(480, 400).astype(np.float64)
    ww = timg.resize_weight_matrix(640, 533).astype(np.float64)
    exact = np.einsum("oh,bhwc,pw->bopc", wh, img.astype(np.float64), ww, optimize=True)
    np.testing.assert_allclose(ours, exact, atol=1e-3, rtol=0)
    ref = np.asarray(jimg.preprocess_images(img, (400, 400), "shrink"))
    np.testing.assert_allclose(ours, ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(480, 400), (640, 533), (400, 100), (100, 400)])
def test_resize_weights_match_jax(n_in, n_out):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    ref = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel, True))
    np.testing.assert_allclose(timg.resize_weight_matrix(n_in, n_out).T, ref, atol=2e-7, rtol=0)


def test_normalization_matches_jax():
    img = _frames()
    norm = {"mean": [0.5, 0.4, 0.3], "stdev": [0.5, 0.25, 0.2]}
    ref = np.asarray(jimg.preprocess_and_normalize(img, (400, 400), "shrink-and-crop", norm))
    ours = timg.preprocess_and_normalize(torch.from_numpy(img), (400, 400), "shrink-and-crop", norm)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
    ours_plain = timg.preprocess_and_normalize(torch.from_numpy(img), (400, 400), "none", None)
    np.testing.assert_allclose(ours_plain.numpy(), img / 255.0, atol=1e-6)


def test_create_belief_maps_matches_jax():
    kp = np.array([[[40.0, 30.0], [10.0, 50.0], [2.0, 3.0], [77.9, 57.2]]], np.float32)
    ref = np.asarray(jbm.create_belief_maps(kp, (80, 60)))
    ours = tbm.create_belief_maps(torch.from_numpy(kp), (80, 60)).numpy()
    assert ours.shape == (1, 4, 60, 80)
    np.testing.assert_allclose(ours, ref, atol=1e-7)


@pytest.mark.parametrize("n", [1, 5, 12, 13, 25, 37, 100, 400])
def test_blur_band_holds_the_whole_operator(n):
    """The kernel's banded weights rebuild the dense folded operator exactly,
    and the dense operator equals the JAX package's."""
    dense = score_kernel._blur_operator(n, 3.0)
    np.testing.assert_array_equal(dense, jbm._blur_operator(n, 3.0))
    band = score_kernel._blur_band(n, 3.0)
    rebuilt = np.zeros_like(dense)
    for i in range(n):
        for t in range(-12, 13):
            if 0 <= i + t < n:
                rebuilt[i, i + t] = band[i, t + 12]
    np.testing.assert_array_equal(rebuilt, dense)


@pytest.mark.parametrize("n", [1, 5, 12, 13, 24, 25, 26, 37, 100, 400])
def test_blur_table_holds_every_row(n):
    """The kernel's compact table gives every row its banded weights, every
    interior row is the table's interior row, the plain Gaussian, and the
    border table holds each border column's weights."""
    band = score_kernel._blur_band(n, 3.0)
    table = score_kernel._blur_table(n, 3.0)
    for b in range(n):
        np.testing.assert_array_equal(table[score_kernel._table_row(b, n)], band[b])
    if n >= 25:
        gauss, _ = score_kernel._gaussian_kernel_scipy(3.0)
        np.testing.assert_array_equal(table[12], gauss)
    edge = score_kernel._edge_table(n, 3.0)
    for x in range(n):
        if x < 12 or x >= n - 12:
            np.testing.assert_array_equal(edge[:, score_kernel._edge_slot(x, n)], band[x])


STRIP = 8  # csrc/score_kernel.cu kStrip


def _fma(a, b, c):
    """f32 fmaf, modelled in float64: the product is exact, the sum rounds."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _emulate_score_kernel(maps, plan):
    """numpy model of csrc/score_kernel.cu under ``plan``: per map, ``cluster``
    blocks walk the bands k, k + cluster, ...; a band stages its rows and 13
    more above and below, blurs its rows and one above and below vertically
    from them in strips of 8 (interior strips first, with
    the Gaussian as weights), then horizontally (interior column
    groups first), then tests the peaks of its rows; block 0 adds the
    blocks' counts.  Asserts that every blurred and scored value is written
    exactly once."""
    n, h, w = maps.shape
    table_h = score_kernel._blur_table(h, 3.0)
    gauss, _ = score_kernel._gaussian_kernel_scipy(3.0)
    edge_w = score_kernel._edge_table(w, 3.0)
    v = plan.vec
    ncg = w // v
    cg_lo = (12 + v - 1) // v
    cg_hi = max(cg_lo, (w - 12 - v) // v + 1 if w - 12 - v >= 0 else 0)
    edge_cgs = [cg for cg in range(ncg) if not cg_lo <= cg < cg_hi]
    scored = np.full_like(maps, np.nan)
    count = np.zeros(n, np.int32)
    for m in range(n):
        block_sums = []
        for rank in range(plan.cluster):
            local = 0
            for band in range(rank, plan.bands, plan.cluster):
                r0 = band * plan.rows
                r1 = min(r0 + plan.rows, h)
                b0, b1 = max(0, r0 - 1), min(h, r1 + 1)
                lo, hi = max(0, r0 - 13), min(h, r1 + 13)  # the rows staged in shared memory
                nb = b1 - b0
                vb = np.full((nb, w), np.nan, np.float32)
                strips = -(-nb // STRIP)
                s_lo = min(strips, 0 if b0 >= 12 else -(-(12 - b0) // STRIP))
                lim = min(h - 12, b1) - STRIP - b0
                s_hi = max(s_lo, min(strips, lim // STRIP + 1 if lim >= 0 else 0))
                for j in list(range(s_lo, s_hi)) + [j for j in range(strips) if not s_lo <= j < s_hi]:
                    interior = s_lo <= j < s_hi
                    y0 = b0 + j * STRIP
                    rows = min(STRIP, b1 - y0)
                    acc = np.zeros((STRIP, w), np.float32)
                    for i in range(STRIP + 24):
                        r = y0 - 12 + i
                        if not lo <= r < hi:
                            assert not interior
                            continue
                        for s in range(min(rows, i + 1)):
                            if i - s < 25:
                                wt = gauss if interior else table_h[score_kernel._table_row(y0 + s, h)]
                                acc[s] = _fma(wt[i - s], maps[m, r], acc[s])
                    assert np.isnan(vb[y0 - b0 : y0 - b0 + rows]).all()
                    vb[y0 - b0 : y0 - b0 + rows] = acc[:rows]
                assert not np.isnan(vb).any()
                hb = np.full_like(vb, np.nan)
                vb_pad = np.pad(vb, ((0, 0), (12, 12)))  # values off the row read as zeros
                cols = np.arange(cg_lo * v, cg_hi * v)
                acc = np.zeros((nb, cols.size), np.float32)
                for t in range(25):
                    acc = _fma(gauss[t], vb_pad[:, cols + t], acc)
                hb[:, cols] = acc
                for x in (cg * v + c for cg in edge_cgs for c in range(v)):
                    acc = np.zeros(nb, np.float32)
                    slot = score_kernel._edge_slot(x, w)
                    for t in range(25):  # zero weight times zero pad outside the row
                        acc = _fma(edge_w[t, slot], vb_pad[:, x + t], acc)
                    assert np.isnan(hb[:, x]).all()
                    hb[:, x] = acc
                assert not np.isnan(hb).any()
                pad = np.pad(hb, ((1, 1), (1, 1)))
                for y in range(r0, r1):
                    r = y - b0 + 1
                    val = pad[r, 1:-1]
                    up = pad[r - 1, 1:-1] if y >= 1 else 0.0
                    down = pad[r + 1, 1:-1] if y < h - 1 else 0.0
                    peak = ((val >= up) & (val >= down) & (val >= pad[r, :-2]) & (val >= pad[r, 2:])
                            & (val > 0.01))
                    assert np.isnan(scored[m, y]).all()
                    scored[m, y] = np.where(peak, maps[m, y], -np.inf)
                    local += int(peak.sum())
            block_sums.append(local)
        count[m] = sum(block_sums)
    assert not np.isnan(scored).any()
    return scored, count


def _noisy_maps(rng, n, h, w, n_blobs=3):
    maps = np.zeros((n, h, w), np.float32)
    for _ in range(n_blobs):
        kp = rng.uniform([0, 0], [w, h], size=(n, 1, 2)).astype(np.float32)
        amp = rng.uniform(0.2, 1.0, size=(n, 1, 1)).astype(np.float32)
        maps += amp * np.asarray(jbm.create_belief_maps(kp, (w, h)))[:, 0]
    return maps + rng.rand(n, h, w).astype(np.float32) * 0.004


def _plan(h, w, rows=None, cluster=None, vec=None):
    """score_plan, or a hand-made plan of ``rows``-row bands (a block then
    walks several bands when they outnumber ``cluster``)."""
    if rows is None:
        return score_kernel.score_plan(h, w, vec=vec, cluster=cluster)
    vec = vec or (4 if w % 4 == 0 else 1)
    bands = -(-h // rows)
    return score_kernel.ScorePlan(rows, min(cluster or 1, bands), bands, vec,
                                  score_kernel.smem_bytes(rows, h, w))


@pytest.mark.parametrize(
    "shape,plan",
    [
        ((2, 400, 400), {}),  # vgg-F size: 8 blocks a map, 50-row bands
        ((3, 37, 53), {"rows": 7, "cluster": 2}),  # W % 4 != 0; 3 bands a block
        ((2, 100, 100), {}),  # vgg-Q size: one block a map
        ((2, 30, 40), {"rows": 40}),
        ((2, 100, 100), {"cluster": 4}),  # vgg-Q size in 4 blocks, 25-row bands
        ((5, 12, 12), {}),  # H < 25: no interior row or column, float4 columns
        ((2, 64, 50), {"cluster": 2}),  # W % 4 != 0 with interior columns
    ],
)
def test_score_kernel_tiling_matches_plain(shape, plan):
    rng = np.random.RandomState(2)
    maps = _noisy_maps(rng, *shape)
    n, h, w = shape
    scored, count = _emulate_score_kernel(maps, _plan(h, w, **plan))
    scored_p, count_p = score_kernel.score_maps_plain(torch.from_numpy(maps))
    np.testing.assert_array_equal(count, count_p.numpy())
    np.testing.assert_array_equal(scored, scored_p.numpy())


def test_rows_per_block_fits_shared_memory():
    plan = score_kernel.score_plan
    assert plan(100, 100) == score_kernel.ScorePlan(100, 1, 1, 4, 80000)  # one block a vgg-Q map
    assert plan(400, 400) == score_kernel.ScorePlan(50, 8, 8, 4, 204800)  # a cluster of 8
    assert plan(7, 53) == score_kernel.ScorePlan(7, 1, 1, 1, 2968)
    assert plan(100, 100, cluster=4) == score_kernel.ScorePlan(25, 4, 4, 4, 31200)
    for h, w in [(37, 53), (400, 400), (100, 1900), (401, 399), (200, 1000), (3000, 400),
                 (5, 300), (12, 12)]:
        p = plan(h, w)
        assert p.smem == score_kernel.smem_bytes(p.rows, h, w) <= 232448 - 128
        assert (p.bands - 1) * p.rows < h <= p.bands * p.rows
        assert 1 <= p.cluster <= min(8, p.bands) and w % p.vec == 0
    assert plan(200, 1000).bands > plan(200, 1000).cluster  # blocks walk several bands
    with pytest.raises(ValueError):
        plan(100, 4000)
    with pytest.raises(ValueError):
        plan(10, 10000)
    with pytest.raises(ValueError):
        plan(10, 50, vec=4)


@pytest.mark.parametrize("w", [1, 25, 399, 1000, 1900, 1936])
@pytest.mark.parametrize("h", [1, 26, 100, 2000])
def test_score_plan_takes_every_width_up_to_1936(h, w):
    """Every map up to 1,936 wide, which the kernel's first version took,
    has a cut whose bands cover it and fit the shared memory; a band needs
    its rows and 13 more above and below, and one row more each side
    blurred."""
    p = score_kernel.score_plan(h, w)
    assert p.smem == 4 * w * (min(h, p.rows + 26) + min(h, p.rows + 2)) <= 232448 - 128
    assert (p.bands - 1) * p.rows < h <= p.bands * p.rows
    assert 1 <= p.cluster <= min(8, p.bands)


def test_score_maps_dispatch_by_device():
    maps = torch.from_numpy(_noisy_maps(np.random.RandomState(3), 2, 30, 40))
    before = score_kernel.score_maps_kernel.launches
    scored, count = score_kernel.score_maps(maps)
    ref_scored, ref_count = score_kernel.score_maps_plain(maps)
    assert torch.equal(count, ref_count) and torch.equal(scored, ref_scored)
    assert count.dtype == torch.int32
    assert score_kernel.score_maps_kernel.launches == before
    with pytest.raises(ValueError):
        score_kernel.score_maps_kernel(maps)


def _compare_peaks(maps, offset=0.0, max_peaks=8):
    """Port decode vs both dream_tpu decode paths, at the bounds of
    tests/test_pallas_kernels.py (coords 1e-4, scores 1e-5, equal counts)."""
    ours = tbm.peaks_from_belief_maps(torch.tensor(np.asarray(maps)), offset, max_peaks)
    refs = [
        jbm.peaks_from_belief_maps(maps, offset, max_peaks=max_peaks),
        peaks_from_belief_maps_pallas(maps, offset, max_peaks=max_peaks, interpret=True),
    ]
    for ref in refs:
        np.testing.assert_array_equal(ours["count"].numpy(), np.asarray(ref["count"]))
        valid = np.asarray(ref["valid"])
        np.testing.assert_array_equal(ours["valid"].numpy(), valid)
        for key, atol in [("coords", 1e-4), ("scores", 1e-5)]:
            np.testing.assert_allclose(
                ours[key].numpy()[valid], np.asarray(ref[key])[valid], atol=atol, err_msg=key
            )


def _peak_cases(name):
    """[4, 60, 80] maps: one shape for every case keeps jax's compiles shared."""
    res = (80, 60)
    if name == "single":
        kp = jnp.array([[40.0, 30.0], [10.0, 50.0], [70.0, 8.0], [33.0, 21.0]])
        return np.asarray(jbm.create_belief_maps(kp, res))
    if name == "multi_and_empty":
        one = lambda x, y: np.asarray(jbm.create_belief_maps(jnp.array([[x, y]]), res))[0]
        return np.stack([
            one(20.0, 20.0) + 0.6 * one(70.0, 40.0) + 0.3 * one(50.0, 50.0),
            np.zeros((60, 80), np.float32),
            one(15.0, 45.0) + 0.9 * one(60.0, 12.0),
            one(5.0, 5.0),
        ])
    return _noisy_maps(np.random.RandomState(0), 4, 60, 80)


@pytest.mark.parametrize("case", ["single", "multi_and_empty", "noisy"])
def test_peaks_match_both_jax_paths(case):
    _compare_peaks(_peak_cases(case), offset=0.4395)


def test_peaks_batched_shapes():
    maps = _noisy_maps(np.random.RandomState(4), 4, 60, 80)
    out = tbm.peaks_from_belief_maps(torch.from_numpy(maps.reshape(2, 2, 60, 80)), 0.4395, max_peaks=4)
    assert out["coords"].shape == (2, 2, 4, 2) and out["count"].shape == (2, 2)
    flat = tbm.peaks_from_belief_maps(torch.from_numpy(maps), 0.4395, max_peaks=4)
    for key in ("coords", "scores", "valid", "count"):
        assert torch.equal(out[key].reshape(flat[key].shape), flat[key]), key


@pytest.mark.parametrize("use_scores", [True, False])
def test_keypoints_from_belief_maps_matches_jax(use_scores):
    rng = np.random.RandomState(5)
    maps = _noisy_maps(rng, 7, 100, 100, n_blobs=2).reshape(1, 7, 100, 100)
    maps[0, 0] = 0.0  # no peak -> sentinel
    ref, _ = jbm.keypoints_from_belief_maps(maps, 0.4395, use_belief_peak_scores=use_scores,
                                            decode_backend="xla")
    ours, _ = tbm.keypoints_from_belief_maps(torch.from_numpy(maps), 0.4395,
                                             use_belief_peak_scores=use_scores)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    assert (ours[0, 0] == tbm.NO_DETECTION_SENTINEL).all()
