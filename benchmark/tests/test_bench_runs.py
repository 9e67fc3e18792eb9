"""Whole runs on the CPU at small sizes, past the look for a card: a sound run
is correct; each fault a cell can have, planted in the timed path, and each
cell's control come out not correct against the cell's limits."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))

import calibrate  # noqa: E402
import run  # noqa: E402

SEED = 2**31 + 4242


def train_patch(cell, dtype="float32"):
    """The cell at a small input and batch: every layer of the network, and a
    configuration's ``training_start`` checkpoint, as run on the card."""
    arch = {"compute_dtype": dtype}
    return {"config": {"network": {"architecture": arch, "training": {"config": {
                "net_input_resolution": [64, 64], "net_output_resolution": None, "batch_size": 4,
                "epochs": 1, "optimizer": {"schedule": {"decay_steps": 4}}}}}},
            "traffic": {"image_raw_resolution": [80, 64], "pool_frames": 4, "steps_per_call": 2,
                        "epochs_drawn": 2}}


EVAL_PATCH = {"config": {"network": {"architecture": {"compute_dtype": "float32"}, "training": {"config": {
                  "net_input_resolution": [128, 128], "net_output_resolution": None}}}},
              "traffic": {"image_raw_resolution": [160, 128], "pool_frames": 4, "job_frames": 40,
                          "job_offsets": 8, "check_frames": 32}}
TRAIN_CELLS = ["vgg_q.train_scan_b32", "resnet_h.train_scan_b32"]
EVAL_CELL = "vgg_q.eval_realsense"


def run_cpu(cell, patch):
    return run.run_cell(cell, SEED, 0.5, 0, device="cpu", patch=patch, workers=1)


def not_correct(cell, numbers):
    from benchmark.harness import cells, checks

    return not checks.verdict(numbers, cells.checks(cell, ROOT))[0]


@pytest.mark.parametrize("cell", TRAIN_CELLS + [EVAL_CELL])
def test_a_sound_run_is_correct(cell):
    result = run_cpu(cell, EVAL_PATCH if cell == EVAL_CELL else train_patch(cell))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_a_training_fault_is_caught(cell, fault):
    undo = calibrate.plant(fault)
    try:
        result = run_cpu(cell, train_patch(cell))
    finally:
        undo()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_training_control_fails(cell):
    numbers = calibrate.readings(cell, SEED, "fp8", "cpu", train_patch(cell), workers=1)
    assert not_correct(cell, numbers), numbers


@pytest.mark.parametrize("kind,fails", [("int8", "kp_gap_p90_px"), ("bf16_pnp", "pnp_stage_gap_mm")])
def test_an_evaluation_control_fails(kind, fails):
    from benchmark.harness import cells

    numbers = calibrate.readings(EVAL_CELL, SEED, kind, "cpu", EVAL_PATCH, workers=1)
    assert numbers[fails][0] > cells.checks(EVAL_CELL, ROOT)["numbers"][fails]["limit"], numbers


def _altered_answer(monkeypatch):
    from dream_tpu_torch import analysis

    solve = analysis.gv.solve_pnp

    def moved(*args, **kwargs):
        result = solve(*args, **kwargs)
        return result._replace(translation=result.translation + 0.01)

    monkeypatch.setattr(analysis.gv, "solve_pnp", moved)


def _half_batch(monkeypatch):
    from dream_tpu_torch.network import DreamNetwork

    inference = DreamNetwork.inference

    def half(self, x):
        n = max(1, x.shape[0] // 2)
        maps, kp = inference(self, x[:n])
        reps = -(-x.shape[0] // n)
        return maps.repeat(reps, 1, 1, 1)[:x.shape[0]], kp.repeat(reps, 1, 1)[:x.shape[0]]

    monkeypatch.setattr(DreamNetwork, "inference", half)


def _stale(monkeypatch):
    """Each call answers with what the call before it computed."""
    from dream_tpu_torch import analysis

    evaluate, previous = analysis.evaluate_frames, []

    def stale(*args, **kwargs):
        previous.append(evaluate(*args, **kwargs))
        return previous[-2] if len(previous) > 1 else previous[-1]

    monkeypatch.setattr(analysis, "evaluate_frames", stale)


@pytest.mark.parametrize("plant", [_altered_answer, _half_batch, _stale])
def test_an_evaluation_fault_is_caught(plant, monkeypatch):
    plant(monkeypatch)
    result = run_cpu(EVAL_CELL, EVAL_PATCH)
    assert not result["correct"], result["checks"]
    assert all(c["value"] is None or math.isfinite(c["value"]) or np.isinf(c["value"])
               for c in result["checks"].values())


@pytest.mark.parametrize("kind,fails", [("drop_detections", "found_mismatch"), ("invalid_pnp", "stage_valid_mismatch")])
def test_a_dropped_answer_is_caught(kind, fails):
    undo = calibrate.plant(kind)
    try:
        result = run_cpu(EVAL_CELL, EVAL_PATCH)
    finally:
        undo()
    check = result["checks"][fails]
    assert not result["correct"] and check["value"] > check["limit"], result["checks"]
