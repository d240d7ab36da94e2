"""The readers of the port's own solve spans and copy counters on a hand-made
event list: ``nlheat.solve.*`` user annotations with their
``gpu_user_annotation`` twins, kernels, and the state's copies each way."""

import pytest

from nonlocalheatequation_torch.obs import metrics as port_metrics
from portbench import devtrace, harness
from portbench.tests.test_portbench_trace import Event

READERS = ("solve_upload_ms", "solve_program_ms", "solve_fetch_ms", "copy_gbps.h2d",
           "copy_gbps.d2h")


def ranged(name, start, end):
    """A ``nlheat.solve.<name>`` range: the host's annotation and its twin on
    the card's timeline."""
    return [Event(f"nlheat.solve.{name}", start, end, "user_annotation", False),
            Event(f"nlheat.solve.{name}", start, end, "gpu_user_annotation", True)]


def events(program=True, spans=True):
    """A 1000 ns window with two solves (100-500, 500-900).  Solve 1: upload
    110-150 (its copy 120-150), program 150-160, kernels 170-300 and
    310-400, fetch 300-480 (its copy 410-470).  Solve 2: upload 510-560
    (copy 520-560), program 560-570, a kernel 580-700, fetch 650-880 (copy
    710-870)."""
    evs = [
        Event("portbench.window", 0, 1000, "user_annotation", False),
        Event("portbench.solve", 100, 500, "user_annotation", False),
        Event("portbench.solve", 500, 900, "user_annotation", False),
        Event("Memcpy HtoD (Pageable -> Device)", 120, 150, "gpu_memcpy", True),
        Event("step2d_fast", 170, 300, "kernel", True),
        Event("step2d_fast", 310, 400, "kernel", True),
        Event("Memcpy DtoH (Device -> Pageable)", 410, 470, "gpu_memcpy", True),
        Event("Memcpy HtoD (Pageable -> Device)", 520, 560, "gpu_memcpy", True),
        Event("step2d_fast", 580, 700, "kernel", True),
        Event("Memcpy DtoH (Device -> Pageable)", 710, 870, "gpu_memcpy", True),
    ]
    if spans:
        evs += ranged("upload", 110, 150) + ranged("fetch", 300, 480)
        evs += ranged("upload", 510, 560) + ranged("fetch", 650, 880)
        if program:
            evs += ranged("program", 150, 160) + ranged("program", 560, 570)
    return evs


def view(evs, traced=True):
    trace = devtrace.parse(evs) if traced else None
    cell = harness.Cell.load("grid2d-eps8-8192.solo-long")
    win = harness.Window(t_open=0.0, t_close=2.0, latencies=[0.5, 0.5, 0.5],
                         traced=2 if traced else 0, trace=trace)
    return harness.RunView(cell, 7.0, win, points=1000, steps=10, step_bytes=8000,
                           bandwidth=1e12,
                           merged=devtrace.merged_busy(trace) if traced else None)


@pytest.fixture
def counters(monkeypatch):
    """The port's registry as four solves left it: 100 bytes a solve in, 200
    out."""
    reg = port_metrics.MetricsRegistry()
    reg.counter("/solver/solves").inc(4)
    reg.counter("/solver/h2d-bytes").inc(400)
    reg.counter("/solver/d2h-bytes").inc(800)
    monkeypatch.setattr(port_metrics, "REGISTRY", reg)
    return reg


def read(run):
    return {n: harness.reader(n)(run) for n in READERS}


def test_each_reader_on_a_hand_made_run(counters):
    got = read(view(events()))
    assert got["solve_upload_ms"] == pytest.approx((40 + 50) / 2 / 1e6)
    assert got["solve_program_ms"] == pytest.approx((10 + 10) / 2 / 1e6)
    # after the last kernel that ended inside each fetch: 480 - 400, 880 - 700
    assert got["solve_fetch_ms"] == pytest.approx((80 + 180) / 2 / 1e6)
    # 100 B a solve x 2 solves over 30 + 40 ns of HtoD; 200 x 2 over 60 + 160 of DtoH
    assert got["copy_gbps.h2d"] == pytest.approx(200 / 70)
    assert got["copy_gbps.d2h"] == pytest.approx(400 / 220)


def test_a_fetch_with_no_kernel_inside_counts_whole(counters):
    evs = [e for e in events() if not (e.name() == "step2d_fast" and e.start_ns() == 580)]
    # solve 2's fetch (650-880) then holds no kernel's end: all 230 ns count
    assert read(view(evs))["solve_fetch_ms"] == pytest.approx((80 + 230) / 2 / 1e6)


def test_program_reads_zero_where_solves_made_none(counters):
    got = read(view(events(program=False)))
    assert got["solve_program_ms"] == 0.0
    assert got["solve_upload_ms"] == pytest.approx(45 / 1e6)


def test_every_reader_finds_nothing_without_a_trace(counters):
    assert read(view(events(), traced=False)) == dict.fromkeys(READERS)


def test_a_program_without_the_spans_or_counters_gives_nothing(monkeypatch):
    monkeypatch.setattr(port_metrics, "REGISTRY", port_metrics.MetricsRegistry())
    # the parent's program: no nlheat.solve.* range, no /solver/* counter
    assert read(view(events(spans=False))) == dict.fromkeys(READERS)
    # spans but no counters: the copies' rates alone find nothing
    got = read(view(events()))
    assert got["copy_gbps.h2d"] is None and got["copy_gbps.d2h"] is None
    assert got["solve_upload_ms"] is not None


def test_the_twins_change_neither_busy_nor_kernel_time():
    with_spans, without = devtrace.parse(events()), devtrace.parse(events(spans=False))
    assert devtrace.merged_busy(with_spans).tolist() == devtrace.merged_busy(without).tolist()
    assert devtrace.kernel_seconds(with_spans) == devtrace.kernel_seconds(without)
    assert not any(d[0].startswith("nlheat.") for d in with_spans.device)
    # the ranges are the host's, and name the idle gaps they cover
    assert sum(h[0].startswith("nlheat.solve.") for h in with_spans.host) == 6
    gaps = dict(devtrace.breakdown(with_spans)["idle_gaps"])
    assert {"nlheat.solve.program", "nlheat.solve.fetch"} <= set(gaps)
