"""Share of the card's bf16 peak the evaluation's forward reaches: the
forward's operations a frame from the configuration's layer shapes, times the
traced window's frames a second, over 989 TFLOP/s."""

from benchmark.harness.yardstick import BF16_FLOPS_PER_S


def read(run):
    stats = run["stats"]
    if run["trace"] is None or "frame_flops" not in stats:
        return None
    return 100.0 * stats["frame_flops"] * stats["eval_frames_per_s"] / BF16_FLOPS_PER_S
