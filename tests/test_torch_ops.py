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


def _emulate_score_kernel(maps, rows):
    """numpy model of csrc/score_kernel.cu: row bands with 13-row halos,
    vertical then horizontal 25-tap blur from the banded weights (taps
    summed in ascending order), zero-filled 4-neighbour test."""
    n, h, w = maps.shape
    band_h = score_kernel._blur_band(h, 3.0)
    band_w = score_kernel._blur_band(w, 3.0)
    scored = np.full_like(maps, -np.inf)
    count = np.zeros(n, np.int32)
    for m in range(n):
        for r0 in range(0, h, rows):
            r1 = min(r0 + rows, h)
            lo, hi = max(0, r0 - 13), min(h, r1 + 13)
            b0, b1 = max(0, r0 - 1), min(h, r1 + 1)
            tile = maps[m, lo:hi]
            vb = np.zeros((b1 - b0, w), np.float32)
            for rb in range(b1 - b0):
                b = b0 + rb
                for t in range(max(0, 12 - b), min(25, h - b + 12)):
                    vb[rb] += band_h[b, t] * tile[b + t - 12 - lo]
            hb = np.zeros_like(vb)
            padded = np.pad(vb, ((0, 0), (12, 12)))
            for t in range(25):
                hb += band_w[:, t][None, :] * padded[:, t : t + w]
            pad = np.pad(hb, 1)
            for y in range(r0, r1):
                r = y - b0 + 1
                v = pad[r, 1:-1]
                up = pad[r - 1, 1:-1] if y >= 1 else 0.0
                down = pad[r + 1, 1:-1] if y < h - 1 else 0.0
                peak = (v >= up) & (v >= down) & (v >= pad[r, :-2]) & (v >= pad[r, 2:]) & (v > 0.01)
                scored[m, y] = np.where(peak, maps[m, y], -np.inf)
                count[m] += int(peak.sum())
    return scored, count


def _noisy_maps(rng, n, h, w, n_blobs=3):
    maps = np.zeros((n, h, w), np.float32)
    for _ in range(n_blobs):
        kp = rng.uniform([0, 0], [w, h], size=(n, 1, 2)).astype(np.float32)
        amp = rng.uniform(0.2, 1.0, size=(n, 1, 1)).astype(np.float32)
        maps += amp * np.asarray(jbm.create_belief_maps(kp, (w, h)))[:, 0]
    return maps + rng.rand(n, h, w).astype(np.float32) * 0.004


@pytest.mark.parametrize(
    "shape,rows", [((2, 400, 400), None), ((3, 37, 53), 7), ((2, 100, 100), None), ((2, 30, 40), 40)]
)
def test_score_kernel_tiling_matches_plain(shape, rows):
    rng = np.random.RandomState(2)
    maps = _noisy_maps(rng, *shape)
    n, h, w = shape
    rows = rows or score_kernel.rows_per_block(h, w)
    scored, count = _emulate_score_kernel(maps, rows)
    scored_p, count_p = score_kernel.score_maps_plain(torch.from_numpy(maps))
    np.testing.assert_array_equal(count, count_p.numpy())
    np.testing.assert_array_equal(scored, scored_p.numpy())


def test_rows_per_block_fits_shared_memory():
    assert score_kernel.rows_per_block(100, 100) == 25  # 4 blocks per vgg-Q map
    assert score_kernel.rows_per_block(400, 400) == 16
    assert score_kernel.rows_per_block(7, 53) == 7
    for h, w in [(37, 53), (400, 400), (100, 1900)]:
        rows = score_kernel.rows_per_block(h, w)
        assert 1 <= rows <= h and (2 * rows + 28) * w * 4 <= 232448
    with pytest.raises(ValueError):
        score_kernel.rows_per_block(10, 4000)


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
