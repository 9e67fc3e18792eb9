"""Re-run the PnP / ADD stage of a dataset analysis from its keypoints.csv.

The port of ``scripts/resolve_pnp.py``: it reads the detected and
ground-truth 2D keypoints the evaluation CLI wrote to ``keypoints.csv``,
the ground-truth 3D keypoints and intrinsics of the NDDS dataset, solves
PnP on the device (plain, ``--pnp-reject-outliers-px`` leave-one-out
rejection, or ``--ransac``) and writes ``pnp_results.csv`` (the
evaluation CLI's writer) and ``pnp_resolve_results.txt`` (the PnP section
of the report), so a solver setting can be tried on a saved run without
the network.  The metrics and formats are the evaluation CLI's (ADD AUC
over 0.1 m, frames with at least four in-frame keypoints are viable,
-999.99 for a failed frame).  RANSAC draws its hypotheses from a
generator seeded 0, as the evaluation CLI's does; the JAX package draws
them otherwise, so RANSAC runs agree statistically, not frame for frame.

Example:
  python3 -m dream_tpu_torch.cli.resolve_pnp -k _scratch/eval_x/keypoints.csv \\
      -d _scratch/synth_holdout_64 -m manip_configs/panda.yaml \\
      -o _scratch/eval_x_resolved --pnp-reject-outliers-px 5
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from dream_tpu_torch.analysis import _inframe_counts, pnp_metrics, write_pnp_csv
from dream_tpu_torch.network import resolve_device
from dream_tpu_torch.ops import geometric_vision as gv
from dream_tpu_torch.utils.config import load_yaml
from dream_tpu_torch.utils.ndds import (
    find_ndds_data_in_dir,
    load_camera_intrinsics,
    load_image_resolution,
    load_keypoints,
)


def read_keypoint_csv(path: str):
    """``(names, detected [F, n_kp, 2], ground truth [F, n_kp, 2])`` from a
    ``keypoints.csv`` (columns ``kp{i}x``, ``kp{i}y``, ``kp{i}x_gt``,
    ``kp{i}y_gt``), float32."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"empty keypoints csv: {path}")
    n_kp = len([k for k in rows[0] if k.endswith("x") and "_gt" not in k])
    names = [r["name"] for r in rows]
    det = [[[float(r[f"kp{i}x"]), float(r[f"kp{i}y"])] for i in range(n_kp)] for r in rows]
    gt = [[[float(r[f"kp{i}x_gt"]), float(r[f"kp{i}y_gt"])] for i in range(n_kp)] for r in rows]
    return names, np.array(det, np.float32), np.array(gt, np.float32)


def resolve_pnp(args) -> dict:
    """Solve, write the two files and print the report; returns the PnP
    metrics."""
    names, detected_raw, gt_raw = read_keypoint_csv(args.keypoints_csv)
    n_samples, n_kp = detected_raw.shape[:2]
    manip = load_yaml(args.manipulator_config)["manipulator"]
    keypoint_names = [kp["name"] for kp in manip["keypoints"]]
    if len(keypoint_names) != n_kp:
        raise ValueError(f"manipulator config has {len(keypoint_names)} keypoints but "
                         f"keypoints.csv has {n_kp}")

    found = find_ndds_data_in_dir(args.dataset_dir)
    camera_K = load_camera_intrinsics(found[1]["camera"])
    image_raw_resolution = load_image_resolution(found[1]["camera"])
    by_name = {s["name"]: s for s in found[0]}
    gt_positions = []
    for name in names:
        if name not in by_name:
            raise ValueError(f"sample '{name}' from keypoints.csv not found in dataset dir")
        kp = load_keypoints(by_name[name]["data_path"], manip["name"], keypoint_names)
        gt_positions.append(kp["positions_wrt_cam"])
    gt_positions = np.asarray(gt_positions, np.float32)
    n_inframe = _inframe_counts(gt_raw, image_raw_resolution)

    device = resolve_device(args.device)
    positions = torch.from_numpy(gt_positions).to(device)
    detected = torch.from_numpy(detected_raw).to(device)
    K = torch.as_tensor(np.asarray(camera_K), dtype=torch.float32, device=device)
    if args.ransac:
        generator = torch.Generator(device=device).manual_seed(0)
        results, _ = gv.solve_pnp_ransac(positions, detected, K, generator=generator)
    else:
        results = gv.solve_pnp(positions, detected, K, reject_outliers_px=args.pnp_reject_outliers_px)
    detect_mask = ~((detected[..., 0] < -999.0) & (detected[..., 1] < -999.0))
    adds = gv.add_from_pose(results.translation, results.quaternion, positions, detect_mask,
                            rotation_convention=args.rotation_convention).cpu().numpy()
    valid = results.valid.cpu().numpy()
    translations = results.translation.cpu().numpy()
    quaternions = results.quaternion.cpu().numpy()

    poses_xyzxyzw, pnp_add = [], []
    for i in range(n_samples):
        if valid[i]:
            poses_xyzxyzw.append(translations[i].tolist() + quaternions[i].tolist())
            pnp_add.append(float(adds[i]))
        else:
            poses_xyzxyzw.append([-999.99] * 7)
            pnp_add.append(-999.99)

    os.makedirs(args.output_dir, exist_ok=True)
    write_pnp_csv(os.path.join(args.output_dir, "pnp_results.csv"), names, valid.tolist(),
                  poses_xyzxyzw, pnp_add, n_inframe.tolist())
    metrics = pnp_metrics(pnp_add, n_inframe)
    possible = max(metrics["num_pnp_possible"], 1)
    lines = [
        f"PnP re-solve of: {args.keypoints_csv}",
        f"Dataset: {args.dataset_dir}",
        f"Solver: {'ransac' if args.ransac else 'plain'}"
        + (f" + reject_outliers_px={args.pnp_reject_outliers_px}"
           if args.pnp_reject_outliers_px is not None else ""),
        f"Rotation convention: {args.rotation_convention}",
        "",
        "Percentage of frames where PNP failed when viable (incorrect): "
        f"{100.0 * metrics['num_pnp_not_found'] / possible:.3f}% "
        f"({metrics['num_pnp_not_found']}/{metrics['num_pnp_possible']})",
        "Percentage of frames where PNP was successful when viable (correct): "
        f"{100.0 * metrics['num_pnp_found'] / possible:.3f}% "
        f"({metrics['num_pnp_found']}/{metrics['num_pnp_possible']})",
        f"ADD (m) for frames where PNP was successful when viable (n = {metrics['num_pnp_found']}):",
        f"   AUC: {metrics['add_auc']:.5f}",
        f"      AUC threshold: {metrics['add_auc_thresh']:.5f}",
        f"   Mean: {metrics['add_mean']:.5f}",
        f"   Median: {metrics['add_median']:.5f}",
        f"   Std Dev: {metrics['add_std']:.5f}",
    ]
    report = "\n".join(lines)
    print(report)
    with open(os.path.join(args.output_dir, "pnp_resolve_results.txt"), "w") as f:
        f.write(report + "\n")
    return metrics


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("-k", "--keypoints-csv", required=True,
                        help="keypoints.csv from a prior dataset analysis.")
    parser.add_argument("-d", "--dataset-dir", required=True,
                        help="The NDDS dataset the analysis ran on (for GT 3D keypoints + intrinsics).")
    parser.add_argument("-m", "--manipulator-config", required=True,
                        help="Manipulator YAML (keypoint names/order).")
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("--ransac", action="store_true", default=False)
    parser.add_argument("--pnp-reject-outliers-px", type=float, default=None)
    parser.add_argument("--rotation-convention", default="standard", choices=["standard", "transposed"],
                        help="ADD rotation convention (see geometric_vision.add_from_pose).")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser


if __name__ == "__main__":
    resolve_pnp(make_parser().parse_args())
