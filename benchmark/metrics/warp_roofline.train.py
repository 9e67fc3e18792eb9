"""The augmentation warp's share of its roofline: the least time its work
needs on the card (its float32 input read once, its output written once, at
3.35 TB/s) over the mean device time of a run of the kernel, found in the
trace by name, the runs of replayed CUDA graphs included."""

from benchmark.harness.yardstick import warp_bound_ms


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    runs = trace.kernels_named("warp_kernel")
    if not runs:
        return None
    tc = run["config"]["network"]["training"]["config"]
    width, height = tc["net_input_resolution"]
    bound = warp_bound_ms(int(tc["batch_size"]), height, width, 3)
    mean_ms = sum(e - s for _, s, e in runs) / len(runs) / 1e6
    return 100.0 * bound / mean_ms
