"""The reduction of a profiler trace: busy time as a union, spans, gaps."""

from benchmark.harness import trace


class Event:
    def __init__(self, kind, name, start, end):
        self.kind, self._name, self.start, self.end = kind, name, start, end

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def synthetic():
    return [
        Event("user_annotation", "bench.window", 100, 1100),
        Event("cpu_op", "aten::conv2d", 100, 400),
        Event("cuda_runtime", "cudaGraphLaunch", 500, 520),
        Event("cpu_op", "aten::copy_", 700, 1000),
        Event("kernel", "void warp_kernel<3>(float const*)", 150, 350),   # overlaps the next
        Event("kernel", "gemm", 300, 450),
        Event("gpu_memcpy", "Memcpy HtoD", 600, 650),
        Event("kernel", "gemm", 900, 1200),                               # runs past the window
        Event("kernel", "before", 10, 90),                                # before it
        Event("gpu_user_annotation", "bench.window", 100, 1100),
        Event("user_annotation", "bench.pnp", 880, 1100),
    ]


def test_busy_time_counts_overlaps_once():
    t = trace.reduce(synthetic(), {"pnp": [0.22]})
    assert t.window == (100, 1100)
    assert t.busy == [(150, 450), (600, 650), (900, 1100)]
    assert t.busy_s == 550e-9
    assert t.window_s == 1000e-9
    assert [op[0] for op in t.kernels_named("warp_kernel")] == ["void warp_kernel<3>(float const*)"]
    assert t.kernels_within(*t.spans["pnp"][0]) == 1  # the copy is not a kernel


def test_breakdown_names_devices_ops_and_what_the_host_did_in_the_gaps():
    b = trace.breakdown(trace.reduce(synthetic(), {}))
    assert b["device_ops"][0] == ["gemm", 450e-9]
    gaps = dict((name, s) for name, s in b["idle_gaps"])
    # Gaps: 100-150 begins inside conv2d; 450-600 and 650-900 begin where no
    # host operation runs (the graph launch starts at 500, the copy at 700).
    assert gaps == {"aten::conv2d": 50e-9, "host outside any operation": 400e-9}


def test_union_merges_touching_and_nested_intervals():
    assert trace.union([(5, 9), (0, 3), (3, 4), (6, 7)]) == [(0, 4), (5, 9)]
