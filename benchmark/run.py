"""Run one cell of the benchmark of ``dream_tpu_torch`` and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic and checks are
files under ``benchmark/`` named in ``BENCHMARK.json``.  A run makes its
inputs and weights from ``--seed``, sets up and warms every shape the cell
uses, measures for ``--seconds`` (``--trace 1``: the per-layer metrics, over
a traced window of at most the traffic's ``trace_seconds``), checks what the
timed path produced against the plain reference, and prints one JSON line
last on standard output.  It needs as many CUDA devices as the cell asks for,
and exits non-zero with no result without them, or if JAX or the JAX package
was loaded.
"""

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dream_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


class Context:
    """What a driver sees of the run."""

    def __init__(self, resolved, seed, device, tracer, root, workers, start=None):
        self.cell = resolved["cell"]
        self.config = resolved["config"]
        self.traffic = resolved["traffic"]
        self.seed, self.device, self.tracer, self.root, self.workers = seed, device, tracer, root, workers
        self._mark = time.perf_counter() if start is None else start

    def mark(self, phase: str) -> None:
        """Print on standard error the seconds since the last mark: where set-up goes."""
        now = time.perf_counter()
        print(f"set-up {phase}: {now - self._mark:.3f} s", file=sys.stderr)
        self._mark = now


def backend_flags(torch) -> dict:
    return {"cudnn.enabled": torch.backends.cudnn.enabled, "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def run_cell(cell_name, seed, seconds, trace, device="cuda", root=ROOT, patch=None, workers=0,
             start=None):
    """Set up, measure and check one cell; returns the result dict.  ``patch``
    (``{"config": {...}, "traffic": {...}}``, merged into the loaded files)
    and a CPU ``device`` are for tests at small sizes."""
    import torch

    from benchmark.harness import cells, checks, trace as tracing

    start = _PROCESS_START if start is None else start
    resolved = cells.resolve(cell_name, root)
    for key, values in (patch or {}).items():
        _merge(resolved[key], values)
    device = torch.device(device)
    on_card = device.type == "cuda"
    tracer = tracing.Tracer(bool(trace) and on_card)
    ctx = Context(resolved, int(seed), device, tracer, Path(root), workers, start)
    driver = resolved["driver"]
    print("backend flags " + json.dumps(backend_flags(torch)), file=sys.stderr)
    ctx.mark("process start, imports and the card")

    st = driver.set_up(ctx)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    window_seconds = min(seconds, ctx.traffic["trace_seconds"]) if trace else seconds
    tracer.start()
    if tracer.enabled:
        with tracer.window():
            stats = driver.window(ctx, st, window_seconds)
    else:
        stats = driver.window(ctx, st, window_seconds)
    traced = tracer.stop()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:  # read after the window: nvidia-smi is no part of set-up
        print(f"card {torch.cuda.get_device_name(device)}, power limit {_power_limit()} W", file=sys.stderr)

    numbers = driver.check(ctx, st)
    correct, compared = checks.verdict(numbers, resolved["checks"])

    metrics = {}
    if trace:
        run = {"trace": traced, "stats": stats, "config": ctx.config,
               "traffic": ctx.traffic, "device": device}
        for spec in cells.per_layer(cell_name, root):
            value = cells.metric_reader(spec["name"], root).read(run)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        for spec in cells.end_to_end(cell_name, root):
            value = setup_s if spec["name"] == "setup_s" else stats.get(spec["name"])
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(resolved["cell"]["chips"]), "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": int(stats["attempted"]), "failed": int(stats["failed"]),
              "metrics": metrics, "device": dev}
    if traced is not None:
        from benchmark.harness.trace import breakdown

        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = breakdown(traced)
    for name, (value, where) in numbers.items():
        if name not in compared:
            print(f"not compared: {name} {value!r} ({where})", file=sys.stderr)
    # A reading that is not finite fails (``verdict``); JSON has no such number.
    result["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for name, (v, lim) in compared.items()}
    return result


def _merge(base: dict, patch: dict) -> None:
    for key, value in patch.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            _merge(base[key], value)
        elif value is None:
            base.pop(key, None)
        else:
            base[key] = value


def _power_limit():
    """The card's power limit in W, by nvidia-smi, or None where it cannot be read."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cells

    chips = int(cells.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
