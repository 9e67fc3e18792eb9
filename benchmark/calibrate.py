"""The readings that a cell's limits are set from, on the card at the cell's size.

    python3 benchmark/calibrate.py --cell <cell> --seeds 14 --controls 3 [--first-seed N] [--kinds K,...]
        [--patch JSON] [--out FILE]

For each seed: the program's numbers as a run compares them (set-up, its
timed path, the reference; no measured window).  Then on ``--controls``
seeds each control and planted fault:

- training: the control is the reference computed in float8 (``fp8``) in the
  program's place; the faults are half of each batch left out of the loss
  (``half_batch``) and a step that leaves the state unchanged
  (``unchanged``); for a vgg network, the program's quantization-aware
  training (``qat``) is read too;
- evaluation: the control is the program's int8 inference, calibrated on the
  job's first 32 frames (``int8``), and, for the PnP stage, the reference's
  PnP with every intermediate rounded to bfloat16, in the program's place on
  the program's own keypoints (``bf16_pnp``; ``tf32_pnp``, float32 with TF32
  matmuls, is read too: the program pins TF32 off there); the faults are
  every eighth keypoint's detection dropped (``drop_detections``) and every
  eighth frame's PnP marked as failed (``invalid_pnp``).

``--kinds float32`` reads the program computing in float32 instead of the
configuration's dtype: a witness that the program and the reference agree
where their precisions do.  ``--kinds float64`` (training) reads the program
and the float32 reference each against the reference in float64
(``prog.*``, ``ref32.*``): how far float32 itself lies from the exact steps.

Prints one JSON line a reading and, last, the largest reading of each number
over the sound seeds and the smallest over each control's seeds.  Not part
of a benchmark run.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed, kind, device, patch=None, workers=0):
    """The numbers a run of ``cell`` compares, from the program (``kind``
    ``program``, or with a fault planted by :func:`plant`) or a control."""
    import torch

    from benchmark.harness import cells, checks, trace as tracing
    sys.path.insert(0, str(ROOT / "benchmark"))
    import run

    resolved = cells.resolve(cell, ROOT)
    for key, values in (patch or {}).items():
        run._merge(resolved[key], values)
    if kind == "qat":
        resolved["config"]["network"]["architecture"]["quant_mode"] = "qat"
    if kind == "float32":
        resolved["config"]["network"]["architecture"]["compute_dtype"] = "float32"
    ctx = run.Context(resolved, seed, torch.device(device), tracing.Tracer(False), ROOT, workers)
    driver = resolved["driver"]
    st = driver.set_up(ctx)
    if resolved["traffic"]["kind"] == "eval_frames":
        st["last"] = driver.job(ctx, st, 1)  # the window's first job
        if kind == "int8":
            from dream_tpu_torch import analysis

            job = st["last"]
            which = st["which"][job["offset"]:job["offset"] + int(ctx.traffic["job_frames"])]
            gt = {"projections": st["pool"]["projections"][which], "positions": st["pool"]["positions"][which]}
            frames = st["frames"][job["offset"]:job["offset"] + int(ctx.traffic["job_frames"])]
            job["result"] = analysis.evaluate_frames(st["net"], frames, gt, st["pool"]["camera_K"],
                                                     batch_size=int(ctx.traffic["batch_size"]),
                                                     int8_calibration_frames=min(32, len(frames)))
        if kind in ("tf32_pnp", "bf16_pnp"):
            _pnp_control(st, kind)
        return driver.check(ctx, st)
    if kind in ("fp8", "float64"):
        driver.release(st)
        from benchmark.reference.models import exact_float32

        with exact_float32():
            ref = driver.reference(ctx, st)
            if kind == "fp8":
                return checks.train_numbers(driver.reference(ctx, st, "fp8"), ref)
            exact = driver.reference(ctx, st, "float64")
        numbers = {"ref32." + k: v for k, v in checks.train_numbers(ref, exact).items()}
        numbers.update({"prog." + k: v for k, v in checks.train_numbers(st["prog"], exact).items()})
        return numbers
    return driver.check(ctx, st)


class _RoundEvery:
    """While active, every torch function's floating result is rounded to
    ``dtype`` (its arithmetic stays in the input's): a program that keeps every
    intermediate in ``dtype``."""

    def __init__(self, dtype):
        import torch

        class Mode(torch.overrides.TorchFunctionMode):
            def __torch_function__(mode, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                return _round(out, dtype)

        self.mode = Mode()

    def __enter__(self):
        return self.mode.__enter__()

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _round(out, dtype):
    import torch

    if isinstance(out, torch.Tensor) and out.is_floating_point() and out.dtype != dtype:
        return out.to(dtype).to(out.dtype)
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(_round(o, dtype) for o in out)
    if hasattr(out, "_fields"):  # torch.return_types
        return type(out)(tuple(_round(o, dtype) for o in out))
    return out


def _pnp_control(st, kind):
    """A PnP control in the program's place on the program's own keypoints:
    the reference's PnP in float32 with TF32 matmuls (``tf32_pnp``) or with
    every intermediate rounded to bfloat16 (``bf16_pnp``), on the card."""
    import contextlib

    import numpy as np
    import torch

    from benchmark.reference import pnp

    job, result = st["last"], st["last"]["result"]
    rows = st["which"][job["offset"]:job["offset"] + len(result["add"])]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    positions = torch.from_numpy(st["pool"]["positions"][rows]).to(device)
    detected = torch.from_numpy(np.asarray(result["detected_raw"], np.float64)).to(device)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    if kind == "tf32_pnp":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    rounding = _RoundEvery(torch.bfloat16) if kind == "bf16_pnp" else contextlib.nullcontext()
    try:
        with rounding:
            valid, R, t = pnp.solve(positions, detected, torch.from_numpy(st["pool"]["camera_K"]).to(positions.device),
                                    torch.float32)
            add = pnp.add(R, t, positions, (detected > -999.0).all(-1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    result["pnp_valid"] = valid.cpu().numpy()
    result["add"] = np.where(result["pnp_valid"], add.double().cpu().numpy(), -999.99)


def plant(kind):
    """Plant a fault in the program's training step or evaluation; returns its undo."""
    from dream_tpu_torch import analysis
    from dream_tpu_torch.network import DreamNetwork

    if kind == "drop_detections":
        inference = DreamNetwork.inference

        def dropped(self, x):
            maps, kp = inference(self, x)
            kp = kp.clone()
            kp.view(-1, 2)[::8] = -999.999
            return maps, kp

        DreamNetwork.inference = dropped
        return lambda: setattr(DreamNetwork, "inference", inference)
    if kind == "invalid_pnp":
        solve = analysis.gv.solve_pnp

        def failed(*args, **kwargs):
            result = solve(*args, **kwargs)
            valid = result.valid.clone()
            valid[::8] = False
            return result._replace(valid=valid)

        analysis.gv.solve_pnp = failed
        return lambda: setattr(analysis.gv, "solve_pnp", solve)
    if kind == "half_batch":
        original = DreamNetwork._forward_terms

        def half(self, net_input, target, variables=None):
            n = net_input.shape[0] // 2
            return original(self, net_input[:n], target[:n], variables)

        DreamNetwork._forward_terms = half
    elif kind == "unchanged":
        original = DreamNetwork._apply_gradients
        DreamNetwork._apply_gradients = lambda self: None
    else:
        return lambda: None
    name = "_forward_terms" if kind == "half_batch" else "_apply_gradients"
    return lambda: setattr(DreamNetwork, name, original)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cell", required=True)
    parser.add_argument("--seeds", type=int, default=14)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_011)
    parser.add_argument("--kinds", default="")
    parser.add_argument("--patch", default="", help="JSON merged into the cell's files, as run_cell's patch")
    parser.add_argument("--out")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cells

    traffic = cells.traffic(cells.cell(args.cell, ROOT)["traffic"], ROOT)
    evaluation = traffic["kind"] == "eval_frames"
    arch = cells.config(cells.cell(args.cell, ROOT)["config"], ROOT)["network"]["architecture"]["type"]
    controls = ["int8", "bf16_pnp", "tf32_pnp"] if evaluation else (["fp8", "qat"] if arch == "vgg" else ["fp8"]) + ["half_batch", "unchanged"]
    if args.kinds:
        controls = args.kinds.split(",")
    plan = [("program", args.first_seed + i) for i in range(args.seeds)]
    plan += [(kind, args.first_seed + 1000 + i) for kind in controls for i in range(args.controls)]
    out = open(args.out, "a") if args.out else None
    worst = {}
    for kind, seed in plan:
        undo = plant(kind)
        t0 = time.perf_counter()
        try:
            numbers = readings(args.cell, seed, kind, "cuda" if torch.cuda.is_available() else "cpu",
                               json.loads(args.patch) if args.patch else None)
        finally:
            undo()
        line = {"cell": args.cell, "kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
                "numbers": {k: [v, where] for k, (v, where) in numbers.items()}}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for name, (value, _) in numbers.items():
            pick = max if kind == "program" else min
            key = (kind, name)
            value = value if math.isfinite(value) else math.inf
            worst[key] = value if key not in worst else pick(worst[key], value)
    summary = {}
    for (kind, name), value in worst.items():
        summary.setdefault(name, {})[("max " if kind == "program" else "min ") + kind] = value
    print(json.dumps({"cell": args.cell, "summary": summary}))


if __name__ == "__main__":
    main()
