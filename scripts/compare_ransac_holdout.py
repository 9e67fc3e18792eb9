#!/usr/bin/env python3
"""RANSAC PnP at holdout scale: dream_tpu against its PyTorch port, on the CPU.

Both packages re-solve the poses of one ``keypoints.csv`` (an evaluation
run's detections) against the NDDS dataset it was made on, as
``resolve_pnp --ransac`` does, once for each of ``--seeds`` seeds:
``dream_tpu``'s ``solve_pnp_ransac`` vmapped over frames under
``jax.random.split(PRNGKey(seed), frames)`` (seed 0 is what
``scripts/resolve_pnp.py --ransac`` runs), the port's batched
``solve_pnp_ransac`` under a ``torch.Generator`` seeded ``seed`` (seed 0 is
what ``dream_tpu_torch.cli.resolve_pnp --ransac`` runs).  The two draw
their hypotheses differently, so they are compared as distributions: PnP
successes and ADD AUC (0.1 m) per seed, and the frames whose ADD exceeds
5 cm.  The plain solve of each package is printed beside them.

A third column, ``port_reference_theta``, runs the port's RANSAC under the
same generator with ``dream_tpu``'s rotation angle ``theta = |r| + eps`` in
place of the port's ``sqrt(|r|^2 + eps^2)`` (patched into the module for
the run, the package untouched): the one line where the two solvers part
on purpose (ROADMAP.md section 3).  The frames whose ADD the patch moves by
more than 1 mm are listed per seed.  Two more columns take the draw out:
the port given ``dream_tpu``'s own hypothesis subsets (``jax.random.choice``
under each frame's key, as ``solve_pnp_ransac`` draws them), with its own
theta (``port_jax_subsets``) and with ``dream_tpu``'s
(``port_reference_theta_jax_subsets``); for each, the frames whose
validity or ADD (to 1 mm) differs from ``dream_tpu``'s are listed per
seed.  Two columns measure ``dream_tpu``'s own rounding spread: its RANSAC
on the same keys with every detection moved by one float32 ulp up
(``dream_tpu_ulp_up``) or down (``dream_tpu_ulp_down``).  Prints one JSON
object.  Imports JAX and dream_tpu: a CPU harness, not part of the port.

Usage:
  python3 scripts/compare_ransac_holdout.py -k <run>/keypoints.csv -d <holdout dir> \\
      [-m manip_configs/panda.yaml] [--seeds 5]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dream_tpu.ops import geometric_vision as jgv  # noqa: E402

from dream_tpu_torch.analysis import _inframe_counts, pnp_metrics  # noqa: E402
from dream_tpu_torch.cli.resolve_pnp import read_keypoint_csv  # noqa: E402
from dream_tpu_torch.ops import geometric_vision as tgv  # noqa: E402
from dream_tpu_torch.utils.config import load_yaml  # noqa: E402
from dream_tpu_torch.utils.ndds import (  # noqa: E402
    find_ndds_data_in_dir,
    load_camera_intrinsics,
    load_image_resolution,
    load_keypoints,
)
from test_torch_pnp_modes import reference_theta  # noqa: E402


def summary(valid, adds, n_inframe):
    adds = np.where(valid, adds, -999.99)
    metrics = pnp_metrics(adds, n_inframe)
    found = adds > -999.0
    return {"pnp_success": [metrics["num_pnp_found"], metrics["num_pnp_possible"]],
            "add_auc": metrics["add_auc"], "add_mean": metrics["add_mean"],
            "add_median": metrics["add_median"],
            "frames_add_over_5cm": int(np.sum(found & (adds > 0.05)))}


def main():
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-k", "--keypoints-csv", required=True)
    parser.add_argument("-d", "--dataset-dir", required=True)
    parser.add_argument("-m", "--manipulator-config", default=os.path.join(ROOT, "manip_configs/panda.yaml"))
    parser.add_argument("--seeds", type=int, default=5)
    args = parser.parse_args()

    names, detected, gt_raw = read_keypoint_csv(args.keypoints_csv)
    manip = load_yaml(args.manipulator_config)["manipulator"]
    keypoint_names = [kp["name"] for kp in manip["keypoints"]]
    found, configs = find_ndds_data_in_dir(args.dataset_dir)
    K = load_camera_intrinsics(configs["camera"]).astype(np.float32)
    by_name = {s["name"]: s for s in found}
    positions = np.asarray([load_keypoints(by_name[n]["data_path"], manip["name"], keypoint_names)
                            ["positions_wrt_cam"] for n in names], np.float32)
    n_inframe = _inframe_counts(gt_raw, load_image_resolution(configs["camera"]))
    mask = ~((detected[..., 0] < -999.0) & (detected[..., 1] < -999.0))

    def jax_adds(result):
        adds = jax.vmap(jgv.add_from_pose)(result.translation, result.quaternion, jnp.asarray(positions),
                                           jnp.asarray(mask, jnp.float32))
        return np.asarray(result.valid), np.asarray(adds)

    def port_adds(result):
        adds = tgv.add_from_pose(result.translation, result.quaternion, torch.from_numpy(positions),
                                 torch.from_numpy(mask))
        return result.valid.numpy(), adds.numpy()

    Kj, Kt = jnp.asarray(K), torch.from_numpy(K)
    out = {"keypoints_csv": args.keypoints_csv, "frames": len(names), "plain": {}, "ransac": {}}
    out["plain"]["dream_tpu"] = summary(*jax_adds(jax.jit(jax.vmap(
        lambda X, uv: jgv.solve_pnp(X, uv, Kj)))(jnp.asarray(positions), jnp.asarray(detected))), n_inframe)
    out["plain"]["port"] = summary(*port_adds(tgv.solve_pnp(torch.from_numpy(positions),
                                                            torch.from_numpy(detected), Kt)), n_inframe)
    ransac_jax = jax.jit(jax.vmap(lambda X, uv, key: jgv.solve_pnp_ransac(X, uv, Kj, key=key)[0]))
    # solve_pnp_ransac's draws (dream_tpu/ops/geometric_vision.py:557-566).
    draw = jax.jit(jax.vmap(lambda lg, key: jax.vmap(
        lambda k: jax.random.choice(k, lg.shape[0], shape=(4,), replace=False,
                                    p=jax.nn.softmax(lg)))(jax.random.split(key, 64))))
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)

    columns = ("dream_tpu", "port", "port_reference_theta", "port_jax_subsets",
               "port_reference_theta_jax_subsets", "dream_tpu_ulp_up", "dream_tpu_ulp_down")
    moved_ulp = {direction: np.where(mask[..., None], np.nextafter(detected, np.float32(direction)), detected)
                 for direction in (np.inf, -np.inf)}
    runs = {c: [] for c in columns}
    moved, apart = [], {c: [] for c in columns[3:5]}

    def port_ransac(seed, subsets=None):
        generator = torch.Generator().manual_seed(seed)
        result, _ = tgv.solve_pnp_ransac(torch.from_numpy(positions), torch.from_numpy(detected), Kt,
                                         generator=generator, subsets=subsets)
        return port_adds(result)

    def frames_apart(a, b):
        (va, aa), (vb, ab) = a, b
        return [names[i] for i in np.nonzero((va != vb) | (va & ~(np.abs(aa - ab) <= 1e-3)))[0]]

    for seed in range(args.seeds):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(names))
        ref, up, down = (jax_adds(ransac_jax(jnp.asarray(positions), jnp.asarray(uv), keys))
                         for uv in (detected, moved_ulp[np.inf], moved_ulp[-np.inf]))
        subsets = torch.from_numpy(np.array(draw(logits, keys)))
        port, port_subsets = port_ransac(seed), port_ransac(seed, subsets)
        with reference_theta():
            patched, patched_subsets = port_ransac(seed), port_ransac(seed, subsets)
        for column, result in zip(columns, (ref, port, patched, port_subsets, patched_subsets, up, down)):
            runs[column].append(summary(*result, n_inframe))
        for column, result in zip(columns[3:5], (port_subsets, patched_subsets)):
            apart[column].append(frames_apart(result, ref))
        moved.append({names[i]: [float(port[1][i]), float(patched[1][i])]
                      for i in np.nonzero(port[0] & ~(np.abs(port[1] - patched[1]) <= 1e-3))[0]})
    for package, per_seed in runs.items():
        aucs = [r["add_auc"] for r in per_seed]
        out["ransac"][package] = {"per_seed": per_seed, "add_auc_mean": float(np.mean(aucs)),
                                  "add_auc_std": float(np.std(aucs)),
                                  "add_auc_sem": float(np.std(aucs, ddof=1) / np.sqrt(len(aucs)))
                                  if len(aucs) > 1 else None,
                                  "pnp_success": [r["pnp_success"][0] for r in per_seed]}
    out["ransac"]["frames_moved_by_theta"] = moved
    out["ransac"]["frames_apart_from_dream_tpu"] = apart
    print(json.dumps(out))


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
