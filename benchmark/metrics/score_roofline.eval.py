"""The peak decode kernel's share of its roofline: the least time of its work
at the cell's map shapes (each map read once, the scored map and peak counts
written once, at 3.35 TB/s), averaged over a job's decodes, over the mean
device time of a run of the kernel, found in the trace by name."""

from benchmark.harness.yardstick import score_bound_ms


def read(run):
    trace, stats = run["trace"], run["stats"]
    if trace is None or not stats.get("decode_maps"):
        return None
    runs = trace.kernels_named("score_kernel")
    if not runs:
        return None
    shapes = stats["decode_maps"]
    bound = sum(score_bound_ms(*shape) for shape in shapes) / len(shapes)
    mean_ms = sum(e - s for _, s, e in runs) / len(runs) / 1e6
    return 100.0 * bound / mean_ms
