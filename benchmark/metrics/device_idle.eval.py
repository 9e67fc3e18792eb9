"""Share of the traced evaluation window in which no operation ran on the
device: one less the union of the kernels', copies' and fills' intervals over
the window's length."""


def read(run):
    trace = run["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
