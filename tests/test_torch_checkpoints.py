"""The committed vgg-F, ResNet-H and ResNet-F checkpoints in the port.

- Each loads with ``load_state_dict(strict=True)``, its float16 storage
  (the ResNets' ``batch_stats`` included) widened to float32.
- On two rendered 640x480 frames (seed 99) at the sidecar's 400x400 net
  input, float32 on both sides (set in the loaded config dict; the sidecars
  say bfloat16), the belief maps agree with ``dream_tpu``'s to 1e-5 (seen:
  <= 1.3e-6; maps range over about [-0.1, 1]) and the decoded keypoints to
  1e-3 px in the net-output frame (seen: <= 1e-4).

The tests marked ``slow`` (not in tier-1, which runs ``-m 'not slow'``) run
the seed-99 64-frame holdout on the CPU in float32:
- vgg-Q r5 through both packages (``dream_tpu`` from an NDDS dataset on
  disk, as ``tests/test_torch_slice.py`` does for two frames): every
  detected keypoint to 0.01 px in the raw frame, the found counts and PnP
  successes equal, PCK AUC to 1e-3 and ADD AUC to 0.02;
- vgg-F r5, ResNet-H r4 and ResNet-F r5 through the port against their
  committed reports (bf16 TPU runs): in-frame found within 6, out-of-frame
  found within 2, PCK AUC within 0.01, PnP successes at least 57/60, ADD AUC
  within 0.03.
"""

import csv
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dream_tpu.network import create_network_from_config_data
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch import checkpoint
from dream_tpu_torch.analysis import evaluate_frames
from dream_tpu_torch.data.synthetic import generate_synthetic_frames
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {
    "vgg-F": ("trained_models/results_r5/vggf/dream_vgg_f_r5", "trained_models/results_r5/eval_vggf"),
    "resnet-H": ("trained_models/results_r4/resnet_h/dream_resnet_h_r4",
                 "trained_models/results_r4/eval_resnet_clean"),
    "resnet-F": ("trained_models/results_r5/resnetf/dream_resnet_f_r5",
                 "trained_models/results_r5/eval_resnetf"),
}
VGGQ = "trained_models/results_r5/vggq/dream_vgg_q_r5"


def paths(stem):
    return os.path.join(ROOT, stem + ".yaml"), os.path.join(ROOT, stem + ".msgpack")


def port_network(stem):
    """The port's float32 network with the committed weights."""
    config, params = paths(stem)
    cfg = load_yaml(config)
    assert cfg["architecture"]["compute_dtype"] == "bfloat16"
    cfg["architecture"]["compute_dtype"] = "float32"
    net = DreamNetwork.from_checkpoint(cfg, params, device="cpu")
    return net


def jax_network(stem):
    """dream_tpu's float32 network with the committed weights, cast to
    float32 as ``load_network_params`` casts them, without that method's
    full-size ``init`` trace (the restored tree is the same)."""
    config, params = paths(stem)
    cfg = jax_load_yaml(config)
    cfg["architecture"]["compute_dtype"] = "float32"
    net = create_network_from_config_data(cfg)
    with open(params, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    net.variables = jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf, jnp.float32), restored)
    return net


@pytest.mark.parametrize("arch", list(CHECKPOINTS))
def test_committed_checkpoint_loads_and_matches_jax(arch):
    stem, _ = CHECKPOINTS[arch]
    ours, ref = port_network(stem), jax_network(stem)  # load_state_dict(strict=True) inside
    tree = checkpoint.load_flax_checkpoint(paths(stem)[1])
    assert set(tree) == ({"params", "batch_stats"} if arch.startswith("resnet") else {"params"})
    state = ours.model.state_dict()
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(state) == len(leaves) and all(v.dtype == torch.float32 for v in state.values())
    assert {leaf.dtype for leaf in leaves} == {np.dtype(np.float16)}
    if arch.startswith("resnet"):
        stats = tree["batch_stats"]["layer3"]["block5"]["bn2"]
        np.testing.assert_array_equal(state["layer3.block5.bn2.running_var"].numpy(),
                                      stats["var"].astype(np.float32))
        kernel = tree["params"]["up1"]["deconv"]["kernel"]  # HWIO, taps applied unflipped
        np.testing.assert_array_equal(state["up1.deconv.weight"].numpy(),
                                      kernel[::-1, ::-1].transpose(2, 3, 0, 1).astype(np.float32))

    frames = generate_synthetic_frames(2, (640, 480), ours.keypoint_names, seed=99)
    x = ours.preprocess(torch.from_numpy(frames["images"]))
    belief, keypoints = ours.inference(x)
    ref_belief, ref_keypoints = ref.inference(x.numpy())
    side = {"vgg-F": 400, "resnet-H": 208, "resnet-F": 416}[arch]
    assert belief.shape == (2, 7, side, side)
    np.testing.assert_allclose(belief.numpy(), np.asarray(ref_belief), atol=1e-5, rtol=0)
    np.testing.assert_allclose(keypoints.numpy(), np.asarray(ref_keypoints), atol=1e-3, rtol=0)
    assert (keypoints.numpy() > -999).sum() >= 7  # the frames do exercise the decode


def report_metrics(report_dir):
    """The five headline metrics of a committed ``analysis_results.txt``."""
    with open(os.path.join(ROOT, report_dir, "analysis_results.txt")) as f:
        text = f.read()

    def frac(label):
        m = re.search(re.escape(label) + r"[^(]*\((\d+)/(\d+)\)", text)
        return int(m.group(1)), int(m.group(2))

    aucs = [float(v) for v in re.findall(r"^\s*AUC: ([0-9.]+)", text, flags=re.M)]
    return {"inframe": frac("in-frame gt keypoints found (correct)"),
            "outframe": frac("out-of-frame gt keypoints found (incorrect)"),
            "pnp": frac("PNP was successful when viable (correct)"),
            "pck_auc": aucs[0], "add_auc": aucs[1]}


@pytest.mark.slow
def test_vggq_holdout_matches_jax_keypoint_by_keypoint(tmp_path):
    from dream_tpu.analysis import analyze_ndds_dataset
    from dream_tpu.data.synthetic import generate_synthetic_ndds

    data_dir, out_dir = str(tmp_path / "frames"), str(tmp_path / "eval")
    generate_synthetic_ndds(data_dir, n_frames=64, seed=99)
    config, params = paths(VGGQ)
    ref_kp, ref_pnp = analyze_ndds_dataset(
        params, config, data_dir, out_dir, visualize_belief_maps=False,
        batch_size=16, num_workers=1, dream_network=jax_network(VGGQ),
    )
    with open(os.path.join(out_dir, "keypoints.csv")) as f:
        rows = list(csv.reader(f))[1:]
    ref_detected = np.array([[float(v) for v in r[1:15]] for r in rows]).reshape(64, 7, 2)

    net = port_network(VGGQ)
    frames = generate_synthetic_frames(64, (640, 480), net.keypoint_names, seed=99)
    gt = {"projections": frames["projections"], "positions": frames["positions"]}
    result = evaluate_frames(net, frames["images"], gt, frames["camera_K"], batch_size=16)
    np.testing.assert_allclose(result["detected_raw"], ref_detected, atol=1e-2, rtol=0)
    kp, pnp = result["keypoints"], result["pnp"]
    for key in ("num_gt_inframe", "num_found_gt_inframe", "num_gt_outframe", "num_found_gt_outframe"):
        assert kp[key] == ref_kp[key], key
    assert pnp["num_pnp_found"] == ref_pnp["num_pnp_found"]
    assert pnp["num_pnp_possible"] == ref_pnp["num_pnp_possible"]
    np.testing.assert_allclose(kp["l2_error_auc"], ref_kp["l2_error_auc"], atol=1e-3)
    np.testing.assert_allclose(pnp["add_auc"], ref_pnp["add_auc"], atol=2e-2)
    print(f"vgg-Q r5 float32 CPU: {kp['num_found_gt_inframe']}/{kp['num_gt_inframe']}, "
          f"{kp['num_found_gt_outframe']}/{kp['num_gt_outframe']}, PCK {kp['l2_error_auc']:.5f}, "
          f"PnP {pnp['num_pnp_found']}/{pnp['num_pnp_possible']}, ADD {pnp['add_auc']:.5f} "
          f"(dream_tpu: PCK {ref_kp['l2_error_auc']:.5f}, ADD {ref_pnp['add_auc']:.5f})")


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(CHECKPOINTS))
def test_holdout_meets_committed_report(arch):
    stem, report = CHECKPOINTS[arch]
    net = port_network(stem)
    frames = generate_synthetic_frames(64, (640, 480), net.keypoint_names, seed=99)
    gt = {"projections": frames["projections"], "positions": frames["positions"]}
    result = evaluate_frames(net, frames["images"], gt, frames["camera_K"], batch_size=16)
    kp, pnp, ref = result["keypoints"], result["pnp"], report_metrics(report)
    print(f"{arch} float32 CPU: {kp['num_found_gt_inframe']}/{kp['num_gt_inframe']}, "
          f"{kp['num_found_gt_outframe']}/{kp['num_gt_outframe']}, PCK {kp['l2_error_auc']:.5f}, "
          f"PnP {pnp['num_pnp_found']}/{pnp['num_pnp_possible']}, ADD {pnp['add_auc']:.5f} "
          f"(report: {ref})")
    assert (kp["num_gt_inframe"], kp["num_gt_outframe"]) == (ref["inframe"][1], ref["outframe"][1])
    assert abs(kp["num_found_gt_inframe"] - ref["inframe"][0]) <= 6
    assert abs(kp["num_found_gt_outframe"] - ref["outframe"][0]) <= 2
    assert abs(kp["l2_error_auc"] - ref["pck_auc"]) <= 0.01
    assert pnp["num_pnp_possible"] == ref["pnp"][1] and pnp["num_pnp_found"] >= 57
    assert abs(pnp["add_auc"] - ref["add_auc"]) <= 0.03
