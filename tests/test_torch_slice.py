"""The port's main path end to end against dream_tpu, on two rendered frames.

Two 640x480 synthetic panda frames (seed 99) are written to disk as an NDDS
dataset by ``dream_tpu.data.synthetic`` and rendered in memory by the port's
copy; they must be identical.  Then ``dream_tpu.analysis.analyze_ndds_dataset``
evaluates the dataset from disk and ``dream_tpu_torch.analysis.evaluate_frames``
the in-memory frames, both in float32 with the committed vgg-Q weights:
preprocessing, model, peak decode, coordinate map, PnP and metrics.

Detections must agree keypoint by keypoint to 0.01 px in the raw frame (the
net-output frame's ~1e-3 px, scaled by 4.8), and pose-derived numbers to
the PnP tolerances of tests/test_torch_pnp_metrics.py.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dream_tpu.analysis import analyze_ndds_dataset
from dream_tpu.data.synthetic import generate_synthetic_ndds
from dream_tpu.network import create_network_from_config_data
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch.analysis import evaluate_frames
from dream_tpu_torch.data.synthetic import generate_synthetic_frames
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
PARAMS = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_network():
    """dream_tpu's float32 vgg-Q network with the committed weights, cast to
    float32 as ``load_network_params`` casts them, without that method's
    full-size ``init`` trace (the restored tree is the same)."""
    cfg = jax_load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    net = create_network_from_config_data(cfg)
    with open(PARAMS, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    net.variables = jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf, jnp.float32), restored)
    return net


def test_two_frame_slice_matches_jax(tmp_path):
    from PIL import Image

    data_dir = str(tmp_path / "frames")
    generate_synthetic_ndds(data_dir, n_frames=2, seed=99)
    frames = generate_synthetic_frames(2, (640, 480), seed=99)
    for i in range(2):
        np.testing.assert_array_equal(
            frames["images"][i], np.asarray(Image.open(os.path.join(data_dir, f"{i:06d}.rgb.png")))
        )
        with open(os.path.join(data_dir, f"{i:06d}.json")) as f:
            kps = json.load(f)["objects"][0]["keypoints"]
        np.testing.assert_array_equal(frames["projections"][i], [k["projected_location"] for k in kps])
        np.testing.assert_array_equal(frames["positions"][i], [k["location"] for k in kps])

    jax_net = jax_network()
    out_dir = str(tmp_path / "eval")
    ref_kp, ref_pnp = analyze_ndds_dataset(
        PARAMS, CONFIG, data_dir, out_dir, visualize_belief_maps=False,
        batch_size=2, num_workers=1, dream_network=jax_net,
    )
    with open(os.path.join(out_dir, "keypoints.csv")) as f:
        rows = list(csv.reader(f))[1:]
    ref_detected = np.array([[float(v) for v in r[1:15]] for r in rows]).reshape(2, 7, 2)
    with open(os.path.join(out_dir, "pnp_results.csv")) as f:
        pnp_rows = list(csv.reader(f))[1:]
    ref_add = np.array([float(r[9]) for r in pnp_rows])

    cfg = load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    torch_net = DreamNetwork.from_checkpoint(cfg, PARAMS, device="cpu")
    gt = {"projections": frames["projections"], "positions": frames["positions"]}
    result = evaluate_frames(torch_net, frames["images"], gt, frames["camera_K"], batch_size=2)

    np.testing.assert_allclose(result["detected_raw"], ref_detected, atol=1e-2, rtol=0)
    assert (ref_detected > -999).sum() >= 10  # the frames do exercise the decode
    kp = result["keypoints"]
    for key in ("num_gt_inframe", "num_found_gt_inframe", "num_gt_outframe", "num_found_gt_outframe"):
        assert kp[key] == ref_kp[key], key
    np.testing.assert_allclose(kp["l2_error_mean_px"], ref_kp["l2_error_mean_px"], atol=1e-2)
    np.testing.assert_allclose(kp["l2_error_auc"], ref_kp["l2_error_auc"], atol=1e-3)
    assert result["pnp"]["num_pnp_found"] == ref_pnp["num_pnp_found"] == 2
    np.testing.assert_allclose(result["add"], ref_add, atol=1e-3)
    np.testing.assert_allclose(result["pnp"]["add_auc"], ref_pnp["add_auc"], atol=2e-2)
