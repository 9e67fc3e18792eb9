"""The trained 17-keypoint network, baxter ResNet-H r5, through the port.

``trained_models/results_r5/baxter_resnet_h/dream_baxter_resnet_h_r5`` is
loaded by both packages' loaders with ``compute_dtype`` set to float32 in
the loaded config dict (the sidecar says bfloat16).

- Tier-1: on two rendered 640x480 baxter frames (17 keypoints, seed 96) at
  the sidecar's 400x400 net input, the port's 17 x 208 x 208 belief maps
  agree with ``dream_tpu``'s to 1e-5 (seen: 6e-7; the maps range over about
  [-0.1, 1]) and the decoded keypoints to 1e-3 px in the net-output frame
  (seen: 4e-5), with every keypoint of both frames found.  The port's
  network is built without drawing its initial parameters (``torch``'s
  truncated-normal draw of ResNet-H's 105 convs takes ~22 s on a CPU):
  ``load_state_dict(strict=True)`` overwrites every parameter and buffer.
- ``slow``: the 64-frame holdout written by the port's dataset CLI (``-m
  manip_configs/baxter.yaml -n 64 --seed 96 --holdout``, as
  ``scripts/r5_artifact_queue.sh:120`` writes it) through the port's
  evaluation CLI in float32 with its mosaics, held to the committed report
  of the bf16 TPU run (``results_r5/eval_baxter_r5``) under vgg-F's bounds
  (PERF.md section 2): in-frame found within 6, out-of-frame found within
  2, PCK AUC within 0.01, PnP successes at least the report's less 2, ADD
  AUC within 0.03; the CSVs' headers equal the report's and their
  ground-truth columns equal its own (the same holdout), and the three
  17-keypoint mosaics are written.  ~4 min on a CPU.
"""

import csv
import os

import numpy as np
import pytest
import torch

from dream_tpu_torch.cli import make_synthetic_dataset as dataset_cli
from dream_tpu_torch.cli import network_inference_dataset as eval_cli
from dream_tpu_torch.data.synthetic import generate_synthetic_frames
from dream_tpu_torch.models import layers
from test_torch_checkpoints import ROOT, jax_network, paths, port_network, report_metrics

STEM = "trained_models/results_r5/baxter_resnet_h/dream_baxter_resnet_h_r5"
REPORT = "trained_models/results_r5/eval_baxter_r5"


def test_baxter_maps_and_keypoints_match_dream_tpu(monkeypatch):
    monkeypatch.setattr(layers, "lecun_normal_", lambda weight, generator=None: weight)
    ours, ref = port_network(STEM), jax_network(STEM)
    assert len(ours.keypoint_names) == 17
    frames = generate_synthetic_frames(2, (640, 480), ours.keypoint_names, seed=96)
    x = ours.preprocess(torch.from_numpy(frames["images"]))
    belief, keypoints = ours.inference(x)
    ref_belief, ref_keypoints = ref.inference(x.numpy())
    assert belief.shape == (2, 17, 208, 208)
    np.testing.assert_allclose(belief.numpy(), np.asarray(ref_belief), atol=1e-5, rtol=0)
    np.testing.assert_allclose(keypoints.numpy(), np.asarray(ref_keypoints), atol=1e-3, rtol=0)
    assert bool((keypoints > -999).all())


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.mark.slow
def test_baxter_holdout_meets_committed_report(tmp_path):
    hold, out = str(tmp_path / "baxter_hold64"), str(tmp_path / "eval")
    dataset_cli.main(dataset_cli.make_parser().parse_args(
        ["-m", os.path.join(ROOT, "manip_configs/baxter.yaml"), "-o", hold, "-n", "64", "--seed", "96",
         "--holdout", "--device", "cpu"]))
    kp, pnp = eval_cli.network_inference_dataset(eval_cli.make_parser().parse_args(
        ["-i", paths(STEM)[1], "-d", hold, "-o", out, "-b", "8", "-w", "2", "--compute-dtype", "float32",
         "--device", "cpu"]))
    ref = report_metrics(REPORT)
    print(f"baxter ResNet-H r5 float32 CPU: {kp['num_found_gt_inframe']}/{kp['num_gt_inframe']}, "
          f"{kp['num_found_gt_outframe']}/{kp['num_gt_outframe']}, PCK {kp['l2_error_auc']:.5f}, "
          f"PnP {pnp['num_pnp_found']}/{pnp['num_pnp_possible']}, ADD {pnp['add_auc']:.5f} (report: {ref})")
    assert (kp["num_gt_inframe"], kp["num_gt_outframe"]) == (ref["inframe"][1], ref["outframe"][1])
    assert abs(kp["num_found_gt_inframe"] - ref["inframe"][0]) <= 6
    assert abs(kp["num_found_gt_outframe"] - ref["outframe"][0]) <= 2
    assert abs(kp["l2_error_auc"] - ref["pck_auc"]) <= 0.01
    assert pnp["num_pnp_possible"] == ref["pnp"][1] and pnp["num_pnp_found"] >= ref["pnp"][0] - 2
    assert abs(pnp["add_auc"] - ref["add_auc"]) <= 0.03

    header, rows = _csv(os.path.join(out, "keypoints.csv"))
    ref_header, ref_rows = _csv(os.path.join(ROOT, REPORT, "keypoints.csv"))
    assert header == ref_header and len(header) == 1 + 4 * 17
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    gt = np.array([[float(v) for v in r[35:]] for r in rows])
    np.testing.assert_allclose(gt, np.array([[float(v) for v in r[35:]] for r in ref_rows]), atol=1e-3)
    assert _csv(os.path.join(out, "pnp_results.csv"))[0] == _csv(os.path.join(ROOT, REPORT, "pnp_results.csv"))[0]
    for name in ("best_samples.png", "medians_samples.png", "worst_samples.png"):
        assert os.path.getsize(os.path.join(out, name)) > 0
