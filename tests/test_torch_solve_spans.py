"""The solo solve's own spans and counters on the CPU.

* Under a ``torch.profiler`` capture a ``GridSolver`` solve records its
  ``nlheat.solve.upload``, ``nlheat.solve.program`` and
  ``nlheat.solve.fetch`` ranges once each, in that order, inside the solve;
  every solve makes its program again (the multi-step program is made per
  solve today); an rkc solve makes it in the stepper's dispatch.  The
  chunked and throttled forms and ``Solver3D`` upload and fetch the same way.
* With no capture and no tracer a span is the shared no-op and no
  profiler range is entered; a range is a ``cpu_op``, not a user
  annotation (which the profiler twins on the card's timeline); under a
  tracer the same names land in the Chrome JSON; a range that cannot open
  costs the range, never the span.
* ``obs.metrics.REGISTRY`` counts ``/solver/solves`` once a ``do_work`` and
  no ``/solver/h2d-bytes`` or ``/solver/d2h-bytes`` on the CPU (the card's
  byte counts: tests/test_torch_card.py).
"""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from nonlocalheatequation_torch.models import steppers
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.metrics import REGISTRY

CPU = torch.device("cpu")
N, NT, EPS = 16, 3, 2
SPANS = ["nlheat.solve.upload", "nlheat.solve.program", "nlheat.solve.fetch"]
COUNTERS = ("/solver/solves", "/solver/h2d-bytes", "/solver/d2h-bytes")


def _u0(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def _solver(**kw):
    s = Solver2D(N, N, NT, EPS, device=CPU, dtype=torch.float64, **kw)
    s.input_init(_u0((N, N)))
    return s


def _profiled(*solves):
    """Run each callable under one CPU capture, each in a ``test.solve``
    range; returns [(name, start, end)] of those and the ``nlheat.*``
    ranges, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for solve in solves:
            with record_function("test.solve"):
                solve()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("nlheat.") or e.name() == "test.solve"]
    return sorted(events, key=lambda ev: ev[1])


def _per_solve(events):
    """The ``nlheat.*`` names inside each ``test.solve`` range."""
    solves = [ev for ev in events if ev[0] == "test.solve"]
    return [[n for n, s, e in events if n != "test.solve" and s0 <= s and e <= e0]
            for _, s0, e0 in solves]


def _counts():
    return [REGISTRY.counter(name).value for name in COUNTERS]


# -- the solo solve under a capture ------------------------------------------------

def test_a_solve_records_upload_program_fetch_in_order_inside_it():
    events = _profiled(_solver().do_work)
    assert _per_solve(events) == [SPANS]
    spans = [ev for ev in events if ev[0] != "test.solve"]
    assert [n for n, _, _ in spans] == SPANS  # none outside the solve
    (_, up0, up1), (_, pr0, pr1), (_, fe0, fe1) = spans
    assert up0 <= up1 <= pr0 <= pr1 <= fe0 <= fe1


def test_every_solve_makes_its_program_again():
    # the program is made per solve today: the change that makes it once a
    # solver changes this test on purpose
    s = _solver()
    assert _per_solve(_profiled(s.do_work, s.do_work)) == [SPANS, SPANS]


def test_rkc_makes_its_program_in_the_stepper_dispatch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an rkc solve does not make the Euler program")

    monkeypatch.setattr(steppers, "_euler_multi_step_fn", refuse)
    s = Solver2D(20, 20, 2, 5, k=1.0, dt=0.0045, dh=0.02, method="conv", stepper="rkc",
                 stages=8, device=CPU)
    s.input_init(_u0((20, 20)))
    events = _profiled(s.do_work)
    assert _per_solve(events) == [["nlheat.solve.upload", "nlheat.solve.program",
                                   "nlheat.stepper.superstep", "nlheat.solve.fetch"]]
    program, superstep = (ev for ev in events if ev[0] in ("nlheat.solve.program",
                                                            "nlheat.stepper.superstep"))
    assert program[2] <= superstep[1]  # made before the loop runs


@pytest.mark.parametrize("form", ["chunked", "throttled", "3d"])
def test_the_other_forms_upload_and_fetch_once(form):
    if form == "3d":
        s = Solver3D(8, 8, 8, NT, 2, device=CPU, dtype=torch.float64)
        s.input_init(_u0((8, 8, 8)))
    elif form == "chunked":
        s = _solver(logger=lambda t, u: None, nlog=2)
    else:
        s = _solver(nd=2)
    (names,) = _per_solve(_profiled(s.do_work))
    assert names[0] == "nlheat.solve.upload" and names[-1] == "nlheat.solve.fetch"
    assert names.count("nlheat.solve.upload") == names.count("nlheat.solve.fetch") == 1
    # the throttle steps one step function and makes no multi-step program;
    # the chunked form makes one a distinct segment length (2 and 1 here)
    assert names.count("nlheat.solve.program") == {"chunked": 2, "throttled": 0,
                                                   "3d": 1}[form]


# -- off, under a tracer, and never raising -------------------------------------------

def test_no_range_is_entered_with_the_profiler_off_and_no_tracer(monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    class Spy:
        def __init__(self, name):
            self.name, self._range = name, real(name)

        def __enter__(self):
            entered.append(self.name)
            return self._range.__enter__()

        def __exit__(self, *exc):
            return self._range.__exit__(*exc)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Spy)
    assert obs_trace.get_tracer() is None
    assert obs_trace.span("solve.upload") is obs_trace.NULL_SPAN
    _solver().do_work()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):  # the spy sees a capture's ranges
        _solver().do_work()
    assert [n for n in entered if n.startswith("nlheat.")] == SPANS


def test_a_tracer_records_the_solve_spans_with_and_without_a_capture():
    tracer = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tracer)
    try:
        _solver().do_work()
        events = _profiled(_solver().do_work)
    finally:
        obs_trace.set_tracer(prev)
    names = [ev["name"] for ev in tracer.events]
    assert names == [n.removeprefix("nlheat.") for n in SPANS] * 2
    assert _per_solve(events) == [SPANS]


def test_existing_spans_reach_a_capture_without_a_tracer():
    assert obs_trace.get_tracer() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.span("serve.dispatch", cat="serve", chunk=1) as sp:
            assert sp is not obs_trace.NULL_SPAN
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "nlheat.serve.dispatch"]
    # a host operator: no user annotation, so no twin on the card's timeline
    assert ev.activity_type() == "cpu_op" and not ev.is_user_annotation()
    assert obs_trace.span("serve.dispatch") is obs_trace.NULL_SPAN  # the capture is over


def test_a_range_that_cannot_open_costs_the_range_not_the_span(monkeypatch):
    class Broken:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            raise RuntimeError("profiler down")

        def __exit__(self, *exc):
            raise AssertionError("a range that never opened is not closed")

    tracer = obs_trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Broken)
        with obs_trace.span("a"):
            pass
        with tracer.span("b", cat="t"):
            pass
        monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", lambda name: 1 / 0)
        with tracer.span("c"):
            pass
    assert [ev["name"] for ev in tracer.events] == ["b", "c"]


def test_a_process_without_torch_records_no_range(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.delitem(sys.modules, "torch")
        assert obs_trace.span("x") is obs_trace.NULL_SPAN
        monkeypatch.undo()
        assert obs_trace.span("x") is not obs_trace.NULL_SPAN


# -- the counters -----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_a_cpu_solve_counts_one_solve_and_no_bytes(backend):
    s = _solver(backend=backend)
    before = _counts()
    s.do_work()
    assert [a - b for a, b in zip(_counts(), before, strict=True)] == [1, 0, 0]
