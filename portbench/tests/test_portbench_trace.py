"""The trace arithmetic on a hand-made event list: busy time, idle share,
idle gaps by host activity, the roofline share, the host's share of a
solve."""

import pytest

from portbench import devtrace, harness, yardstick


class Dev:
    name = "CUDA"


class Host:
    name = "CPU"


class Event:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, end, act, device):
        self._n, self._s, self._e, self._a = name, start, end, act
        self._d = Dev() if device else Host()

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def activity_type(self):
        return self._a

    def device_type(self):
        return self._d


def events():
    """A 1000 ns window: two solves (100-500, 500-900); kernels 150-350 and
    300-400 (overlapping), a copy 600-700, a kernel 700-800 and one 950-1100
    past the window's end; the host in aten::copy_ at 420-480 and in a
    synchronize 850-940."""
    return [
        Event("portbench.window", 0, 1000, "user_annotation", False),
        Event("portbench.solve", 100, 500, "user_annotation", False),
        Event("portbench.solve", 500, 900, "user_annotation", False),
        Event("portbench.window", 0, 1000, "gpu_user_annotation", True),
        Event("void carried2d_fast<float, 8>(float const*)", 150, 350, "kernel", True),
        Event("void carried2d_fast<float, 8>(float const*)", 300, 400, "kernel", True),
        Event("Memcpy DtoH (Device -> Pageable)", 600, 700, "gpu_memcpy", True),
        Event("elementwise_kernel", 700, 800, "kernel", True),
        Event("elementwise_kernel", 950, 1100, "kernel", True),
        Event("aten::copy_", 420, 480, "cpu_op", False),
        Event("cudaDeviceSynchronize", 850, 940, "cuda_runtime", False),
    ]


def test_parse_and_busy():
    t = devtrace.parse(events())
    assert t.window == (0, 1000) and t.window_s == 1e-6
    assert len(t.device) == 5 and len(t.spans["solve"]) == 2
    merged = devtrace.merged_busy(t)
    assert merged.tolist() == [[150, 400], [600, 800], [950, 1000]]
    assert devtrace.busy_ns(merged) == 500
    assert devtrace.kernel_seconds(t) == pytest.approx((200 + 100 + 100 + 50) / 1e9)
    assert devtrace.idle_gaps(t) == [(0, 150), (400, 600), (800, 950)]
    assert devtrace.has_kernel(t, ("carried2d",)) and not devtrace.has_kernel(t, ("gather_L",))


def test_busy_before():
    merged = devtrace.merged_busy(devtrace.parse(events()))
    got = devtrace.busy_before(merged, [0, 150, 300, 400, 500, 650, 2000])
    assert got.tolist() == [0, 0, 150, 250, 250, 300, 500]


def test_breakdown_names_the_host_in_each_gap():
    b = devtrace.breakdown(devtrace.parse(events()))
    ops = dict(b["device_ops"])
    assert ops["carried2d_fast<float, 8>"] == pytest.approx(300e-9)
    assert ops["elementwise_kernel"] == pytest.approx(150e-9)
    gaps = dict(b["idle_gaps"])
    # (0,150): no host event at 75; (400,600): the copy at 500? no: aten::copy_
    # ends at 480, so the solve span covers 500; (800,950): the synchronize
    assert gaps == {"(no host event)": pytest.approx(150e-9),
                    "portbench.solve": pytest.approx(200e-9),
                    "cudaDeviceSynchronize": pytest.approx(150e-9)}


def test_readers_on_a_hand_made_run():
    trace = devtrace.parse(events())
    cell = harness.Cell.load("grid2d-eps8-8192.solo-long")
    win = harness.Window(t_open=0.0, t_close=2.0, latencies=[0.5, 1.0, 1.5, 2.5], traced=2,
                         trace=trace)
    view = harness.RunView(cell, 7.0, win, points=1000, steps=10, step_bytes=8000,
                           bandwidth=1e12, merged=devtrace.merged_busy(trace))
    read = {n: harness.reader(n)(view) for n in (
        "throughput", "setup_s", "device_idle_pct", "solve_host_ms",
        "kernel_roofline_pct.grid")}
    assert read["throughput"] == pytest.approx(4 * 1000 * 10 / 2.0 / 1e6)
    assert read["setup_s"] == 7.0
    assert read["device_idle_pct"] == pytest.approx(50.0)
    # the untraced solves' mean wall (1.5 and 2.5 s) less the card's mean busy
    # time inside the two traced solves (250 and 200 ns)
    assert read["solve_host_ms"] == pytest.approx(2000.0 - 225 / 1e6)
    # 20 steps x 8000 B at 1e12 B/s = 160 ns against 450 ns of kernels
    assert read["kernel_roofline_pct.grid"] == pytest.approx(100 * 160 / 450)


def test_readers_find_nothing_to_read_without_a_trace():
    cell = harness.Cell.load("grid2d-eps8-8192.solo-long")
    win = harness.Window(t_open=0.0, t_close=1.0, latencies=[0.5, 0.5])
    view = harness.RunView(cell, 7.0, win, points=1000, steps=10, step_bytes=8000)
    assert view.untraced == []
    for name in ("device_idle_pct", "solve_host_ms", "kernel_roofline_pct.grid"):
        assert harness.reader(name)(view) is None
    # traced to its end: no untraced solve to take the wall from
    trace = devtrace.parse(events())
    win = harness.Window(t_open=0.0, t_close=1.0, latencies=[0.5, 0.5], traced=2,
                         trace=trace)
    view = harness.RunView(cell, 7.0, win, points=1000, steps=10, step_bytes=8000,
                           merged=devtrace.merged_busy(trace))
    assert harness.reader("solve_host_ms")(view) is None


def test_roofline_and_bytes():
    assert yardstick.least_step_bytes(4096 * 4096, 4) == 8 * 4096 * 4096
    # 4096^2 f32 at 3.35 TB/s: 0.0401 ms a step (PERF.md's bound)
    assert 8 * 4096 ** 2 / yardstick.peak_bandwidth("NVIDIA H100 80GB HBM3") * 1e3 \
        == pytest.approx(0.04006, rel=1e-3)
    assert yardstick.roofline_pct(0, 8, 1.0, 1e12) is None
    with pytest.raises(KeyError):
        yardstick.peak_bandwidth("some other card")
