"""Share of the card's bf16 peak the training step reaches: the step's
operations (three forwards from the configuration's layer shapes, nothing
recomputed) times the traced window's steps a second, over 989 TFLOP/s."""

from benchmark.harness.yardstick import BF16_FLOPS_PER_S


def read(run):
    stats = run["stats"]
    if run["trace"] is None or "step_flops" not in stats:
        return None
    steps_per_s = stats["attempted"] / stats["window_s"]
    return 100.0 * stats["step_flops"] * steps_per_s / BF16_FLOPS_PER_S
