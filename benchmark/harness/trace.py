"""The traced run: ``torch.profiler`` over the window, spans around the
program's entry points, and the reduction of the trace to device time.

:class:`Tracer` profiles host and device (CUPTI) activity.  A span is a
``torch.profiler.record_function`` named ``bench.<name>`` around a call into the
program, optionally with a synchronize on both sides, kept with its host-clock
length.  :func:`reduce` reads the raw events (no per-event Python tree is
built) into :class:`Trace`: each device operation (kernel, copy, fill) as
``(name, start, end)`` in nanoseconds, the host's operations, and the spans.
The device is busy where any operation runs: the union of their intervals, so
that overlapping operations count once.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class Trace:
    device_ops: List[Tuple[str, int, int]]
    host_ops: List[Tuple[str, int, int]]
    spans: Dict[str, List[Tuple[int, int]]]
    span_ms: Dict[str, List[float]]
    window: Tuple[int, int]
    busy: List[Tuple[int, int]] = field(default_factory=list)
    kernel_starts: List[int] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernels_named(self, fragment: str) -> List[Tuple[str, int, int]]:
        return [op for op in self.device_ops if fragment in op[0]]

    def kernels_within(self, start: int, end: int) -> int:
        """Kernels (not copies or fills) that start in ``[start, end]``."""
        return bisect.bisect_right(self.kernel_starts, end) - bisect.bisect_left(self.kernel_starts, start)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge ``(start, end)`` intervals into disjoint ones, in order."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def clip(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Tracer:
    """Profiles while active; ``span`` records a named region of the program."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.span_ms: Dict[str, List[float]] = {}
        self._prof = None

    def start(self) -> None:
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()

    def stop(self) -> Optional[Trace]:
        if self._prof is None:
            return None
        self._prof.stop()
        trace = reduce(self._prof.profiler.kineto_results.events(), self.span_ms)
        self._prof = None
        return trace

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
            if sync:
                torch.cuda.synchronize()
        self.span_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    @contextlib.contextmanager
    def window(self):
        """The traced window: synchronized at both ends, so that it holds all
        the device work its host calls made and none from before."""
        torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()


def _activity(ev) -> str:
    """The event's kind as Kineto names it; from its device and name where
    this torch does not say."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    if ev.is_user_annotation():
        return "user_annotation" if ev.device_type() == torch.autograd.DeviceType.CPU else "gpu_user_annotation"
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        name = ev.name().lower()
        return "gpu_memcpy" if "memcpy" in name else "gpu_memset" if "memset" in name else "kernel"
    return "cpu_op"


def reduce(events, span_ms: Dict[str, List[float]]) -> Trace:
    device, host, kernel_starts = [], [], []
    spans: Dict[str, List[Tuple[int, int]]] = {}
    for ev in events:
        kind = _activity(ev)
        s, e = ev.start_ns(), ev.end_ns()
        if kind in DEVICE_ACTIVITIES:
            device.append((ev.name(), s, e))
            if kind == "kernel":
                kernel_starts.append(s)
        elif kind == "user_annotation" and ev.name().startswith("bench."):
            spans.setdefault(ev.name(), []).append((s, e))
        elif kind in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append((ev.name(), s, e))
    if WINDOW not in spans:
        raise RuntimeError("the profiler's trace holds no window annotation")
    window = spans.pop(WINDOW)[0]
    device = sorted(op for op in device if op[2] > window[0] and op[1] < window[1])
    host.sort(key=lambda op: op[1])
    busy = clip(union([(s, e) for _, s, e in device]), *window)
    return Trace(device, host, {k[len("bench."):]: v for k, v in spans.items()}, span_ms, window, busy,
                 sorted(kernel_starts))


def breakdown(trace: Trace, top: int = 10, labelled: int = 20000) -> Dict[str, list]:
    """The device operations that took the most time, summed by name, and the
    idle time of the longest gaps (the ``labelled`` longest) summed by the
    innermost host operation running when each began."""
    by_name: Dict[str, int] = {}
    for name, s, e in trace.device_ops:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [trace.window[0]] + [t for iv in trace.busy for t in iv] + [trace.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [op[1] for op in trace.host_ops]
    idle: Dict[str, int] = {}
    for s, e in gaps[:labelled]:
        label = "host outside any operation"
        i = bisect.bisect_right(starts, s) - 1
        for j in range(i, max(i - 5000, -1), -1):
            name, hs, he = trace.host_ops[j]
            if he >= s:
                label = name
                break
        idle[label] = idle.get(label, 0) + (e - s)
    rest = sum(e - s for s, e in gaps[labelled:])
    if rest:
        idle["shorter gaps, not labelled"] = rest
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v / 1e9] for n, v in ops],
            "idle_gaps": [[n[:200], v / 1e9] for n, v in gaps_out]}
