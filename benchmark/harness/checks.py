"""The numbers that decide ``correct``, and the verdict against their limits.

Training: the program's first three steps against the reference's from the
same weights, frames and augmentation draws.  By the worst leaf, a gap of norms
is ``| |prog| - |ref| |`` measured against the larger of the reference leaf's
norm and the median leaf's.

- ``loss_gap``: the largest relative gap of the three steps' losses;
  ``loss1_gap``: the first step's;
- ``grad_gap``: the first step's clipped gradient as the optimizer got it;
  ``grad_gap_median``: the median leaf's gap of it; ``grad_direction_gap``:
  one less the cosine between the two gradients, all leaves as one vector
  (a gradient of other rows points elsewhere, whatever its norm);
- ``update_gap``: each parameter's change over the three steps;
- ``ema_gap``: the EMA's change over the three steps, where the recipe keeps one.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a bias ahead of a BatchNorm, whose gradient is zero but for rounding, and
which Adam moves by round-off alone) are left out of the two changes.

Evaluation: a sample of a job's frames against the reference.

- ``kp_gap_px``, ``kp_gap_median_px``, ``kp_gap_p90_px``, ``kp_gap_p99_px``:
  the mean, median, 90th and 99th percentile of the pixel distance between
  the program's and the reference's keypoints where both detect one;
- ``found_mismatch``: the share of keypoints that one side detects and the other not;
- ``add_gap_mm``, ``add_gap_p90_mm``: the median and 90th percentile of the
  gap between the program's ADD and the reference's (its PnP on its own
  keypoints), over frames both solve;
- ``pnp_stage_gap_mm``: the median gap between the program's ADD and the
  reference's PnP and ADD on the program's own keypoints: the PnP stage alone;
- ``valid_mismatch``: the share of frames that one side solves and the other not;
  ``stage_valid_mismatch``: the same on the program's own keypoints, the PnP stage alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

GRAD_FLOOR = 1e-3  # of the median leaf's reference gradient


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    gaps = leaf_gaps(prog, ref, keep)
    leaf = max(gaps, key=lambda n: (gaps[n] if math.isfinite(gaps[n]) else math.inf))
    return gaps[leaf], leaf


def train_numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """``prog`` and ``ref``: ``losses`` (3), ``grad``, ``update`` and (with an
    EMA) ``ema``, each a dict of per-leaf norms."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    step = max(range(len(losses)), key=lambda i: losses[i] if math.isfinite(losses[i]) else math.inf)
    median_grad = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= GRAD_FLOOR * median_grad]
    gaps = leaf_gaps(prog["grad"], ref["grad"])
    a, b = prog["grad_vector"].double(), ref["grad_vector"].double()
    scale = float(a.norm() * b.norm())
    cosine = float(a @ b) / scale if scale > 0 else 0.0
    out = {"loss_gap": (losses[step], f"step {step + 1}"),
           "grad_direction_gap": (1.0 - cosine, f"{a.numel()} values"),
           "loss1_gap": (losses[0], "step 1"),
           "grad_gap": worst_leaf(prog["grad"], ref["grad"]),
           "grad_gap_median": (statistics.median(gaps.values()), f"{len(gaps)} leaves"),
           "update_gap": worst_leaf(prog["update"], ref["update"], moved)}
    if ref.get("ema"):
        out["ema_gap"] = worst_leaf(prog["ema"], ref["ema"], moved)
    return out


def eval_numbers(prog_kp: np.ndarray, prog_add: np.ndarray, prog_valid: np.ndarray,
                 ref: dict) -> Dict[str, Tuple[float, str]]:
    """Keypoints ``[S, n, 2]`` in raw pixels (sentinel below -999), ADD in m;
    ``ref``: ``kp``, ``valid``, ``add`` and, on the program's keypoints,
    ``stage_valid``, ``stage_add``."""
    ref_kp, ref_valid, ref_add = ref["kp"], ref["valid"], ref["add"]
    found_p = (prog_kp > -999.0).all(-1)
    found_r = (ref_kp > -999.0).all(-1)
    both = found_p & found_r
    dist = np.linalg.norm(prog_kp - ref_kp, axis=-1)[both]
    solved = prog_valid & ref_valid
    add_gap = np.abs(prog_add - ref_add)[solved] * 1e3
    stage = (np.abs(prog_add - ref["stage_add"]) * 1e3)[prog_valid & ref["stage_valid"]]
    n = f"{int(both.sum())} keypoints"
    f = f"{int(solved.sum())} frames"
    return {
        "kp_gap_px": (float(dist.mean()) if dist.size else math.inf, n),
        "kp_gap_median_px": (float(np.median(dist)) if dist.size else math.inf, n),
        "kp_gap_p90_px": (float(np.percentile(dist, 90)) if dist.size else math.inf, n),
        "kp_gap_p99_px": (float(np.percentile(dist, 99)) if dist.size else math.inf, n),
        "found_mismatch": (float((found_p != found_r).mean()), f"{found_p.size} keypoints"),
        "add_gap_mm": (float(np.median(add_gap)) if add_gap.size else math.inf, f),
        "add_gap_p90_mm": (float(np.percentile(add_gap, 90)) if add_gap.size else math.inf, f),
        "pnp_stage_gap_mm": (float(np.median(stage)) if stage.size else math.inf, f"{stage.size} frames"),
        "valid_mismatch": (float((prog_valid != ref_valid).mean()), f"{prog_valid.size} frames"),
        "stage_valid_mismatch": (float((prog_valid != ref["stage_valid"]).mean()), f"{prog_valid.size} frames"),
    }


def verdict(numbers: Dict[str, Tuple[float, str]], limits: dict) -> Tuple[bool, Dict[str, List[float]]]:
    """``correct`` and ``{name: [value, limit]}`` for every number the cell's
    checks file compares; a number that is missing or not finite fails."""
    compared, correct = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name, (math.nan, ""))[0]
        compared[name] = [value, spec["limit"]]
        if spec["limit"] is None or not (math.isfinite(value) and value <= spec["limit"]):
            correct = False
    return correct, compared
