"""Keypoint counts other than panda's 7 through the port (kuka 8, baxter 17).

``tests/test_multi_robot.py``'s chain through the port, on the CPU: render an
n-keypoint scene, stamp ground-truth belief maps, decode their peaks, map
them back to the raw frame and solve PnP, held to that test's bounds (median
error under 6 px, translation within 5 cm) and to dream_tpu on the same
inputs: the scene equal, the maps within 1e-6, the decoded keypoints'
found state equal and their positions within 1e-3 px (float32 decodes),
the pose within 1e-3 m of dream_tpu's.  The keypoint metrics of the
decode match dream_tpu's (counts equal, errors and AUC within 1e-3, the
decode's tolerance), and so does
the best/median/worst mosaic of ``analysis._write_sample_mosaics`` at 17
keypoints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dream_tpu import analysis as jax_analysis
from dream_tpu.data import synthetic as jax_synthetic
from dream_tpu.ops import coords as jax_coords
from dream_tpu.ops.belief_maps import create_belief_maps as jax_create_belief_maps
from dream_tpu.ops.belief_maps import keypoints_from_belief_maps as jax_keypoints_from_belief_maps
from dream_tpu.ops.geometric_vision import solve_pnp as jax_solve_pnp

from dream_tpu_torch import analysis
from dream_tpu_torch.data import synthetic
from dream_tpu_torch.ops import coords
from dream_tpu_torch.ops.belief_maps import create_belief_maps, keypoints_from_belief_maps
from dream_tpu_torch.ops.geometric_vision import solve_pnp
from dream_tpu_torch.utils.png import read_png

W, H = 640, 480
NETIN, NETOUT = (400, 400), (100, 100)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _port_decode(projs):
    a_in = coords.affine_netin_from_raw((W, H), NETIN, "shrink-and-crop")
    a_out = coords.affine_netout_from_netin(NETIN, NETOUT)
    maps = create_belief_maps(a_out(a_in(torch.as_tensor(projs, dtype=torch.float32)))[None], NETOUT)
    kp_out, _ = keypoints_from_belief_maps(maps, offset_due_to_upsampling=0.4395)
    to_raw = coords.affine_raw_from_netin(NETIN, (W, H), "shrink-and-crop").compose(
        coords.affine_netin_from_netout(NETOUT, NETIN))
    return maps[0].numpy(), to_raw(kp_out[0]).numpy()


def _jax_decode(projs):
    a_in = jax_coords.affine_netin_from_raw((W, H), NETIN, "shrink-and-crop")
    a_out = jax_coords.affine_netout_from_netin(NETIN, NETOUT)
    maps = jax_create_belief_maps(a_out(a_in(jnp.asarray(projs)))[None], NETOUT)
    kp_out, _ = jax_keypoints_from_belief_maps(maps, offset_due_to_upsampling=0.4395)
    kp_raw = jax_coords.affine_raw_from_netin(NETIN, (W, H), "shrink-and-crop")(
        jax_coords.affine_netin_from_netout(NETOUT, NETIN)(kp_out[0]))
    return np.asarray(maps[0]), np.asarray(kp_raw)


@pytest.mark.parametrize("n_kp", [8, 17])
def test_decode_and_pnp_many_keypoints(n_kp):
    img, projs, pos = synthetic.render_random_scene(np.random.RandomState(3), (W, H), n_keypoints=n_kp)
    ref_img, ref_projs, ref_pos = jax_synthetic.render_random_scene(np.random.RandomState(3), (W, H),
                                                                    n_keypoints=n_kp)
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(projs, ref_projs)
    np.testing.assert_array_equal(pos, ref_pos)
    assert img.shape == (H, W, 3) and projs.shape == (n_kp, 2)
    K = np.array([[0.96 * W, 0, W / 2.0], [0, 0.96 * W, H / 2.0], [0, 0, 1.0]])

    maps, kp_raw = _port_decode(projs)
    ref_maps, ref_kp_raw = _jax_decode(projs)
    assert maps.shape == (n_kp, NETOUT[1], NETOUT[0])
    np.testing.assert_allclose(maps, ref_maps, atol=1e-6, rtol=0)
    detected = kp_raw[:, 0] > -900
    np.testing.assert_array_equal(detected, ref_kp_raw[:, 0] > -900)
    np.testing.assert_allclose(kp_raw[detected], ref_kp_raw[detected], atol=1e-3, rtol=0)
    assert detected.sum() >= 4, detected
    err = np.linalg.norm(kp_raw[detected] - projs[detected], axis=1)
    assert np.median(err) < 6.0, err

    centered = pos - pos.mean(axis=0)
    sol = solve_pnp(torch.as_tensor(centered[None], dtype=torch.float32),
                    torch.as_tensor(kp_raw[None]), torch.as_tensor(K, dtype=torch.float32))
    t = sol.translation[0].numpy()
    assert bool(sol.valid[0]) and np.linalg.norm(t - pos.mean(axis=0)) < 0.05, (t, pos.mean(axis=0))
    ref = jax_solve_pnp(jnp.asarray(centered), jnp.asarray(ref_kp_raw), jnp.asarray(K))
    np.testing.assert_allclose(t, np.asarray(ref.translation), atol=1e-3, rtol=0)

    ours_m = analysis.keypoint_metrics(kp_raw, projs, (W, H))
    ref_m = jax_analysis.keypoint_metrics(ref_kp_raw, projs, (W, H))
    for key, value in ref_m.items():
        if isinstance(value, int):
            assert ours_m[key] == value, key
        elif value is not None:
            np.testing.assert_allclose(ours_m[key], value, atol=1e-3, rtol=0, err_msg=key)


class _Frames:
    """What ``_write_sample_mosaics`` reads of a dataset: frames and their
    ground truth."""

    def __init__(self, images, projs):
        self.images, self.kp_projs_raw = images, projs

    def load_images(self, indices):
        return self.images[np.asarray(indices)]


def test_sample_mosaics_at_17_keypoints(tmp_path):
    rng = np.random.RandomState(17)
    scenes = [synthetic.render_random_scene(rng, (W, H), n_keypoints=17) for _ in range(3)]
    images = np.stack([s[0] for s in scenes])
    projs = np.stack([s[1] for s in scenes]).astype(np.float32)
    results = []
    for i in range(3):
        _, kp_raw = _port_decode(projs[i])
        results.append((i, {"name": f"{i:06d}", "detected_raw": kp_raw},
                        analysis.sample_l2_metric(kp_raw, projs[i].astype(float), (W, H))))
    frames = _Frames(images, projs)
    (tmp_path / "ours").mkdir()
    (tmp_path / "ref").mkdir()
    analysis._write_sample_mosaics(str(tmp_path / "ours"), frames, results)
    jax_analysis._write_sample_mosaics(str(tmp_path / "ref"), frames, results)
    for group in ("best", "medians", "worst"):
        ours = read_png(str(tmp_path / "ours" / f"{group}_samples.png"))
        assert ours.shape == (H, W, 3)
        np.testing.assert_array_equal(
            ours, np.asarray(Image.open(tmp_path / "ref" / f"{group}_samples.png").convert("RGB")))
