"""The port's load balancer (parallel/load_balance.py) and elastic executor
(parallel/elastic.py) against the JAX package's on the CPU.

The balancer's decisions are integers: ``work_realloc`` and
``rebalance_assignment`` must equal the JAX package's step for step, on the
reference's three ``data/load_balance_*.txt`` fixtures and on the
adversarial starts of tests/test_load_balance_adversarial.py (the same
seeds).  The report prints the same lines.  The executor runs
``method="cuda"`` (on the CPU the plain ``nsum2d``) on virtual CPU devices
and the JAX executor its default ``shift`` on the suite's virtual devices,
both in float64 at small sizes: the results agree to 1e-12, and across
placements and migration histories the port is bitwise equal to itself.
A virtual-clock dragged device (tests/test_load_balance.py's
``_DraggedDeviceSolver`` on the JAX side) ends in the same assignment.
"""

import functools

import numpy as np
import pytest

import jax

from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.parallel import elastic as tel
from nonlocalheatequation_torch.parallel import load_balance as tlb
from nonlocalheatequation_torch.parallel.mesh import device_list
from nonlocalheatequation_torch.utils.partition_map import default_assignment, read_partition_map
from nonlocalheatequation_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from nonlocalheatequation_tpu.parallel import elastic as jel
from nonlocalheatequation_tpu.parallel import load_balance as jlb
from tests.test_load_balance import _DraggedDeviceSolver as JDragged
from tests.test_load_balance_adversarial import _grow_connected_partition

FIXTURES = ("data/load_balance_25s_2n.txt", "data/load_balance_25s_4n.txt",
            "data/load_balance_4s_2n.txt")


def _lockstep(a, speeds, rounds=40):
    """Drive both balancers from one start under WorkTelemetry(speeds):
    every round's rates, deltas, new assignment and stats must be equal."""
    nl = len(speeds)
    ta, ja = a.copy(), a.copy()
    for _ in range(rounds):
        busy = tlb.WorkTelemetry(nl, speed_factors=speeds).busy_rates(ta)
        assert np.array_equal(busy, jlb.WorkTelemetry(nl, speed_factors=speeds).busy_rates(ja))
        assert tlb.balance_check(busy) == jlb.balance_check(busy)
        counts = np.bincount(ta.ravel(), minlength=nl)
        assert np.array_equal(tlb.work_realloc(busy, counts), jlb.work_realloc(busy, counts))
        if tlb.balance_check(busy)[0]:
            break
        tstats, jstats = {}, {}
        ta = tlb.rebalance_assignment(ta, busy, stats=tstats)
        ja = jlb.rebalance_assignment(ja, busy, stats=jstats)
        assert np.array_equal(ta, ja) and tstats == jstats
    return ta


@pytest.mark.parametrize("path", FIXTURES)
def test_rebalance_equals_jax_on_the_reference_fixtures(path):
    a = read_partition_map(path).assignment
    nl = int(a.max()) + 1
    for speeds in (np.ones(nl), np.linspace(1.0, 3.0, nl)):
        _lockstep(a, speeds)


def _adversarial_starts():
    """The starts of tests/test_load_balance_adversarial.py, seeds and all."""
    starts = [
        (np.fromfunction(lambda x, y: (x + y) % 2, (8, 8), dtype=int), np.array([1.0, 3.0])),
        (np.fromfunction(lambda x, y: (x % 2) * 2 + (y % 2), (8, 8), dtype=int),
         np.array([1.0, 2.0, 3.0, 4.0])),
    ]
    island = np.full((9, 9), 2, dtype=np.int64)
    island[2:7, 2:7] = 1
    island[3:6, 3:6] = 0
    starts.append((island, np.array([20.0, 1.0, 1.0])))
    rng = np.random.default_rng(0)
    for _ in range(12):
        nl = int(rng.integers(2, 6))
        npx, npy = int(rng.integers(4, 9)), int(rng.integers(4, 9))
        a = rng.integers(0, nl, size=(npx, npy)).astype(np.int64)
        starts.append((a, rng.uniform(0.5, 2.0, size=nl)))
    rng = np.random.default_rng(1)
    for _ in range(12):
        nl = int(rng.integers(2, 5))
        npx, npy = int(rng.integers(5, 10)), int(rng.integers(5, 10))
        a = _grow_connected_partition(rng, npx, npy, nl)
        starts.append((a, rng.uniform(0.5, 3.0, size=nl)))
    for nl, n in ((2, 21), (3, 21), (5, 20), (7, 21)):
        a = np.full((1, n), nl - 1, dtype=np.int64)
        a[0, :nl - 1] = np.arange(nl - 1)
        starts.append((a, np.ones(nl)))
    return starts


@pytest.mark.parametrize("case", range(len(_adversarial_starts())))
def test_rebalance_equals_jax_on_adversarial_starts(case):
    a, speeds = _adversarial_starts()[case]
    _lockstep(np.asarray(a, dtype=np.int64), np.asarray(speeds, dtype=np.float64))


@pytest.mark.parametrize("a,busy", [
    (np.array([[0, 1, 2, 2, 2]]), np.array([1000.0, 5000.0, 9000.0])),
    (np.arange(4).reshape(2, 2), np.array([10000.0, 9000.0, 500.0, 400.0])),
    (np.random.default_rng(2).integers(0, 4, size=(7, 7)), np.array([9000.0, 4000.0, 2500.0,
                                                                    1200.0])),
    (np.ones((5, 5), dtype=np.int64), np.array([0.0, 10000.0, 0.0])),  # empty receivers
])
def test_single_passes_equal_jax(a, busy):
    tstats, jstats = {}, {}
    out = tlb.rebalance_assignment(a.astype(np.int64), busy, stats=tstats)
    assert np.array_equal(out, jlb.rebalance_assignment(a.astype(np.int64), busy, stats=jstats))
    assert tstats == jstats
    for dev in range(len(busy)):
        assert tlb._region_components(out, dev) == jlb._region_components(out, dev)
        for other in range(len(busy)):
            assert tlb._boundary_grabs(out, dev, other) == jlb._boundary_grabs(out, dev, other)


@pytest.mark.parametrize("busy,counts", [
    ([5000.0, 5000.0, 5000.0], [5, 5, 5]), ([5000.0, 5100.0], [10, 10]),
    ([10000.0, 400.0], [24, 1]), ([10000.0, 0.0, 3000.0], [20, 0, 5]),
])
def test_work_realloc_equals_jax(busy, counts):
    assert np.array_equal(tlb.work_realloc(busy, counts), jlb.work_realloc(busy, counts))


@pytest.mark.parametrize("busy", [[5000.0, 5000.0], [10000.0, 400.0, 9000.0]])
def test_balance_report_prints_the_jax_lines(capsys, busy):
    a = np.array([[0, 1, 1], [1, 0, 0]], dtype=np.int64)
    ok = tlb.print_balance_report(np.array(busy), a)
    ours = capsys.readouterr().out
    assert ok == jlb.print_balance_report(np.array(busy), a)
    assert ours == capsys.readouterr().out


def test_publish_busy_rates_under_the_jax_names():
    ours, theirs = MetricsRegistry(), JMetricsRegistry()
    for moved in (0, 3):
        tlb.publish_busy_rates([8000.0, 10000.0], moved=moved, registry=ours)
        jlb.publish_busy_rates([8000.0, 10000.0], moved=moved, registry=theirs)
    names = ["/device{0}/busy-rate", "/device{1}/busy-rate"]
    assert [ours.gauge(n).value for n in names] == [theirs.gauge(n).value for n in names]
    for n in ("/balance/windows", "/balance/rebalances", "/balance/tiles-moved"):
        assert ours.counter(n).value == theirs.counter(n).value


def test_measured_telemetry_and_fleet_policy_equal_jax():
    t, j = tlb.MeasuredTelemetry(3), jlb.MeasuredTelemetry(3)
    for dev, sec in ((0, 0.2), (1, 0.1), (0, 0.2)):
        t.record(dev, sec)
        j.record(dev, sec)
    assert np.array_equal(t.busy_rates(), j.busy_rates())
    ft, fj = tel.FleetTelemetry(), jel.FleetTelemetry()
    for r, b, s in ((0, 0.9, 1.0), (1, 0.95, 1.0), (2, 0.1, 0.0)):
        ft.record_window(r, b, s)
        fj.record_window(r, b, s)
    assert np.array_equal(ft.busy_rates(), fj.busy_rates())
    for busy, n in (([9000.0, 9500.0], 2), ([1000.0, 500.0], 2), ([5000.0], 1), ([], 3)):
        assert tel.fleet_scale_decision(busy, n) == jel.fleet_scale_decision(busy, n)
        assert tel.fleet_scale_decision(busy, n, n_max=2) == jel.fleet_scale_decision(
            busy, n, n_max=2)
    pt, pj = tel.BusyRatePolicy(tlb.WorkTelemetry(2)), jel.BusyRatePolicy(jlb.WorkTelemetry(2))
    a = np.array([[0, 1], [1, 1]])
    assert np.array_equal(pt.window_rates(a), pj.window_rates(a))
    assert np.array_equal(pt.rates_or_last(a), pj.rates_or_last(a))


# -- the executor against the JAX executor -------------------------------------------------

def _imbalanced(npx=5, npy=5):
    a = np.ones((npx, npy), dtype=np.int64)
    a[0, 0] = 0
    return a


#: name -> (ElasticSolver2D kwargs, device count, WorkTelemetry speeds or None)
CASES = {
    "default": (dict(nx=6, ny=6, npx=4, npy=4, nt=10, eps=2, k=1.0, dt=1e-5, dh=0.02), 4,
                None),
    "imbalanced": (dict(nx=5, ny=5, npx=5, npy=5, nt=12, eps=2, k=1.0, dt=1e-5, dh=0.04,
                        assignment=_imbalanced()), 2, None),
    "eps_over_tile": (dict(nx=4, ny=4, npx=5, npy=5, nt=8, eps=6, k=1.0, dt=1e-5, dh=0.05),
                      4, None),
    "migrated": (dict(nx=4, ny=4, npx=6, npy=6, nt=31, eps=2, nbalance=10, k=0.2, dt=5e-4,
                      dh=0.02, assignment=default_assignment(6, 6, 2)), 2, [1.0, 3.0]),
}


def _kwargs(case, speeds_to):
    kw, ndev, speeds = CASES[case]
    kw = dict(kw)
    if speeds is not None:
        kw["telemetry"] = speeds_to(ndev, speed_factors=np.array(speeds))
    return kw, ndev


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    kw, ndev = _kwargs(case, jlb.WorkTelemetry)
    s = jel.ElasticSolver2D(devices=jax.devices()[:ndev], **kw)
    s.test_init()
    s.do_work()
    return np.asarray(s.u), float(s.error_l2), np.array(s.assignment)


class _PerTile(tel.ElasticSolver2D):
    """Every step through the rectangle walk: no gang stretch."""

    def _gang_stretch_len(self, t, measured):
        return 0


def _torch_run(case, gang=True, **extra):
    kw, ndev = _kwargs(case, tlb.WorkTelemetry)
    kw.update(extra)
    cls = tel.ElasticSolver2D if gang else _PerTile
    s = cls(devices=device_list("cpu", ndev), method="cuda", **kw)
    s.test_init()
    s.do_work()
    return s


@pytest.mark.parametrize("case", sorted(CASES))
def test_elastic_equals_the_jax_executor(case):
    ju, jl2, ja = _jax_run(case)
    s = _torch_run(case)
    assert np.abs(s.u - ju).max() < 1e-12
    n = s.NX * s.NY
    # the l2 norms differ by at most the norm of the states' difference
    assert abs(np.sqrt(s.error_l2) - np.sqrt(jl2)) <= 1e-12 * np.sqrt(n)
    assert np.array_equal(s.assignment, ja)
    assert s.error_l2 / n <= 1e-6
    # bitwise across schedules and placements: the rectangle walk on every
    # step, and every tile on one device (migration moves bits, never recomputes)
    assert np.array_equal(_torch_run(case, gang=False).u, s.u)
    if CASES[case][0].get("nbalance") is None:
        one = _torch_run(case, assignment=np.zeros((s.npx, s.npy), dtype=np.int64))
        assert np.array_equal(one.u, s.u)


def test_elastic_equals_the_serial_solver():
    s = _torch_run("default")
    o = Solver2D(24, 24, 10, 2, k=1.0, dt=1e-5, dh=0.02, device="cpu", method="cuda")
    o.test_init()
    o.do_work()
    assert np.abs(s.u - o.u).max() < 1e-12


def test_migration_moves_tiles_and_rebuilds_the_plan():
    s = tel.ElasticSolver2D(4, 4, 4, 4, nt=2, eps=2, devices=device_list("cpu", 2),
                            method="cuda", dh=0.05)
    s.test_init()
    s.do_work()
    assert s._gang.plan.t_max == 8 and not s._gang_active
    new = np.zeros((4, 4), dtype=np.int64)
    new[0, 0] = 1
    moved = s.migrate(new)
    assert moved == int((new != default_assignment(4, 4, 2)).sum())
    assert np.array_equal(s.assignment, new) and np.array_equal(s.gather(), s.u)
    # the next stretch packs the slots from the new assignment
    s._enter_gang()
    plan = s._gang.plan
    assert plan.order[1] == [(0, 0)] and len(plan.order[0]) == 15 and plan.t_max == 15
    assert s._gang._state[1].shape == (15, 4, 4) and (s._gang._state[1][1:] == 0).all()
    assert np.array_equal(s.gather(), s.u)


def test_dragged_device_reaches_the_jax_assignment():
    """The virtual-clock drag (tests/test_load_balance.py) in both packages:
    the slow device sheds tiles, the measured rates pass the reference's
    check, and the final assignment is the JAX executor's."""

    class Dragged(tel.ElasticSolver2D):
        slow_device, base_s, drag_s = JDragged.slow_device, JDragged.base_s, JDragged.drag_s

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._vclock = 0.0
            self._measure_clock = lambda: self._vclock

        def _tile_hook(self, key):
            self._vclock += self.base_s
            if int(self.assignment[key]) == self.slow_device:
                self._vclock += self.drag_s

    kw = dict(nt=31, eps=2, nbalance=10, k=0.2, dt=0.0005, dh=0.02,
              assignment=default_assignment(6, 6, 2))
    j = JDragged(4, 4, 6, 6, devices=jax.devices()[:2], **kw)
    j.test_init()
    j.do_work()
    s = Dragged(4, 4, 6, 6, devices=device_list("cpu", 2), method="cuda", **kw)
    s.test_init()
    s.do_work()
    counts = np.bincount(s.assignment.ravel(), minlength=2)
    assert counts[s.slow_device] < counts[1 - s.slow_device], counts
    assert np.array_equal(s.assignment, j.assignment)
    assert np.array_equal(s.busy_rates(), j.busy_rates())
    assert tlb.balance_check(s.busy_rates())[0]
    assert np.abs(s.u - np.asarray(j.u)).max() < 1e-12


def test_owner_beyond_the_devices_is_refused():
    with pytest.raises(ValueError, match="re-run the decomposition"):
        tel.ElasticSolver2D(4, 4, 2, 2, nt=1, eps=1, assignment=np.array([[0, 1], [2, 0]]),
                            devices=device_list("cpu", 2))


def test_windows_and_stretches_count_as_in_jax():
    """With nbalance=10 and a 3-step window, 5 of 20 steps are measured and
    the other 15 run in gang stretches (or the rectangle walk without them)."""
    calls = {"measured": 0, "overlapped": 0, "gang": 0}

    def probe(base):
        class Probe(base):
            def _step_all_measured(self, t):
                calls["measured"] += 1
                return super()._step_all_measured(t)

            def _step_all_overlapped(self, t):
                calls["overlapped"] += 1
                return super()._step_all_overlapped(t)

            def _gang_stretch_len(self, t, measured):
                n = super()._gang_stretch_len(t, measured)
                calls["gang"] += n  # do_work runs one stretch of n steps
                return n

        return Probe

    for base, want in ((tel.ElasticSolver2D, (5, 0, 15)), (_PerTile, (5, 15, 0))):
        calls.update(measured=0, overlapped=0, gang=0)
        s = probe(base)(4, 4, 4, 4, nt=20, eps=2, nbalance=10, measure_window=3, k=0.2,
                        dt=5e-4, dh=0.02, devices=device_list("cpu", 2), method="cuda")
        s.test_init()
        s.do_work()
        assert (calls["measured"], calls["overlapped"], calls["gang"]) == want, calls
        assert s.error_l2 / 256 <= 1e-6
