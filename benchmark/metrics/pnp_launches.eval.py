"""Kernels a job's PnP solve runs on the device: those of the trace that start
inside the span around ``solve_pnp`` (synchronized on both sides, so nothing
else runs there), averaged over the traced jobs."""


def read(run):
    trace = run["trace"]
    spans = [] if trace is None else trace.spans.get("pnp", [])
    if not spans:
        return None
    return sum(trace.kernels_within(s, e) for s, e in spans) / len(spans)
