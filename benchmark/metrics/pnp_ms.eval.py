"""Host milliseconds of a job's PnP solve: the span around ``solve_pnp``,
with the device synchronized on both sides, averaged over the traced jobs."""


def read(run):
    trace = run["trace"]
    spans = [] if trace is None else trace.span_ms.get("pnp", [])
    return sum(spans) / len(spans) if spans else None
