#!/usr/bin/env python3
"""Robust PnP on the hard frames: the port's final cost against dream_tpu's, on the CPU.

For each seed, the frames of ``tests/test_torch_pnp_modes.py`` ``_hard``
(five-point frames and frames with two gross outliers) go through the
weighted, rejecting and weighted-rejecting solves of both packages, as
``test_hard_frames_hold_the_final_cost`` runs them: ``dream_tpu`` jitted
over the batch and jitted one frame at a time, the port as it ships and
with ``dream_tpu``'s rotation angle.  Each solve's final weighted
reprojection cost over the points it kept (``_final_cost``) is compared
with the lower of ``dream_tpu``'s two, at a factor of 1.001.  Prints one
JSON object: per frame-mode the costs, and the tally of frame-modes where
the port is lower, higher and level.  Imports JAX and dream_tpu.

    python3 scripts/robust_pnp_hard_frames.py [--seeds 13]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

from dream_tpu_torch.ops import geometric_vision as tgv  # noqa: E402
from test_torch_pnp_modes import (  # noqa: E402
    _FACTOR,
    K,
    _final_cost,
    _hard,
    _jax_solve,
    _jax_solve_one,
    reference_theta,
)


def main():
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--seeds", type=int, default=13)
    args = parser.parse_args()
    torch.set_num_threads(2)
    rows, tally = [], {"port": {"lower": 0, "higher": 0, "level": 0},
                       "port_reference_theta": {"lower": 0, "higher": 0, "level": 0}}
    for seed in range(args.seeds):
        X, uv, weights = _hard(seed)
        for mode in ("weighted", "reject", "weighted+reject"):
            w = weights if "weighted" in mode else np.ones_like(weights)
            reject = 10.0 if "reject" in mode else None
            threshold = np.float32(np.inf if reject is None else reject)
            solve = (torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K))
            ours = tgv.solve_pnp(*solve, weights=torch.from_numpy(w), reject_outliers_px=reject)
            with reference_theta():
                patched = tgv.solve_pnp(*solve, weights=torch.from_numpy(w), reject_outliers_px=reject)
            batch = _jax_solve()(X, uv, w, threshold)
            for i in ([0, 4] if reject is None else range(len(X))):
                one = _jax_solve_one()(X[i], uv[i], w[i], threshold)
                ref = [_final_cost(r.rotation, r.translation, float(r.reproj_error), X[i], uv[i], w[i])
                       for r in (jax.tree_util.tree_map(lambda a: a[i], batch), one)]
                row = {"seed": seed, "mode": mode, "frame": i, "dream_tpu": ref}
                for label, result in (("port", ours), ("port_reference_theta", patched)):
                    cost = _final_cost(result.rotation[i].numpy(), result.translation[i].numpy(),
                                       float(result.reproj_error[i]), X[i], uv[i], w[i])
                    row[label] = cost
                    side = ("higher" if cost > _FACTOR * min(ref)
                            else "lower" if cost * _FACTOR < min(ref) else "level")
                    tally[label][side] += 1
                rows.append(row)
    print(json.dumps({"seeds": args.seeds, "factor": _FACTOR, "tally": tally, "frames": rows}))


if __name__ == "__main__":
    main()
