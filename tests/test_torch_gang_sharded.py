"""The port's hybrid mesh layer (parallel/mesh_axes.py) and the sharded case
class (parallel/gang.solve_case_sharded, the router's gang replica) on the
CPU, held against the JAX package.

* ``pick_gang_devices`` picks the same devices as the JAX function on fleets
  of fake devices spread over granules, and refuses in its words.
* ``create_hybrid_mesh``: one granule is ``mesh.create_mesh`` element for
  element; over several granules (processes) the placement is the JAX
  rule's (compared with the JAX module on the same fake devices), and so
  are its refusals and the axis rules' words.
* ``solve_case_sharded`` on 24² and 32² f64 cases over 2 and 4 virtual CPU
  devices, Euler, rkc and fft: within 1e-12 of the JAX function (8 virtual
  devices there, ``ndevices`` of them picked) and bitwise the port's own
  ``Solver2DDistributed`` on the same mesh; the same info; the bounded LRU
  and the refusals in the JAX words; ``comm='fused'`` engages with
  ``method='cuda'`` (the halo kernels' plain versions here) and is bitwise
  the collective transport.
* ``ReplicaRouter.sharded_fft_capability`` answers as the JAX predicate.
* A gang replica over pipes and over TCP (with a worker SIGKILLed while it
  holds a sharded case) serves Euler, rkc and fft picks bitwise the
  offline ``solve_case_sharded``.
"""

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.parallel import mesh_axes as tma
from nonlocalheatequation_torch.parallel.distributed2d import (
    Solver2DDistributed,
    choose_mesh_for_grid,
)
from nonlocalheatequation_torch.parallel.gang import GANG_SOLVER_CACHE_CAP, solve_case_sharded
from nonlocalheatequation_torch.parallel.mesh import create_mesh, device_list
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase
from nonlocalheatequation_torch.serve.picker import EngineChoice
from nonlocalheatequation_tpu.parallel import gang as jgang
from nonlocalheatequation_tpu.parallel import mesh_axes as jma
from nonlocalheatequation_tpu.serve import ensemble as jens

torch.set_num_threads(1)


class FakeDev:
    """A device of a granule (process) — the JAX suite's fake device, with
    the attributes both packages' granule ladders read."""

    def __init__(self, i, granule):
        self.id = i
        self.process_index = granule
        self.slice_index = granule
        self.platform = "cpu"
        self.device_kind = "cpu"

    def __repr__(self):
        return f"d{self.id}@g{self.process_index}"


def _ids(devs):
    return [d.id for d in devs]


FLEETS = {
    "two-by-four": [FakeDev(i, i // 4) for i in range(8)],
    "interleaved": [FakeDev(i, i % 2) for i in range(8)],
    "uneven-3-5": [FakeDev(i, 0 if i < 3 else 1) for i in range(8)],
    "three-granules": [FakeDev(i, (2, 0, 1, 0, 2, 2, 1, 2)[i]) for i in range(8)],
}


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_pick_gang_devices_matches_jax(fleet):
    devs = FLEETS[fleet]
    for n in range(1, len(devs) + 1):
        assert _ids(tma.pick_gang_devices(n, devs)) == _ids(jma.pick_gang_devices(n, devs))
        assert tma.granule_count(devs) == jma.granule_count(devs)
    for n in (0, 9):
        with pytest.raises(ValueError) as mine:
            tma.pick_gang_devices(n, devs)
        with pytest.raises(ValueError) as theirs:
            jma.pick_gang_devices(n, devs)
        assert str(mine.value) == str(theirs.value)


def test_virtual_devices_are_one_granule():
    devs = device_list("cpu", 8)
    assert tma.granule_count(devs) == 1 and tma.device_granule(devs[0]) == 0
    assert tma.pick_gang_devices(8, devs) == devs
    assert tma.pick_gang_devices(3, devs) == devs[:3]


@pytest.mark.parametrize("axes,shape", [(("x", "y"), (2, 2)), (("x", "y"), (4, 2)),
                                        (("x", "y", "z"), (2, 2, 2)), (("p",), (8,)),
                                        (("case", "x"), (2, 4))])
def test_single_granule_is_create_mesh(axes, shape):
    devs = device_list("cpu", 8)
    got = tma.create_hybrid_mesh(axes, shape, devs)
    want = create_mesh(axes, shape, devs)
    assert got.axis_names == want.axis_names and got.shape == want.shape
    assert got.devices.shape == want.devices.shape
    assert all(a is b for a, b in zip(got.devices.flat, want.devices.flat, strict=True))
    assert (got.ranks == want.ranks).all()
    assert tma.mesh_axis_network(got) == {a: tma.axis_rule(a) for a in axes}


@pytest.mark.parametrize("fleet,axes,shape", [
    ("two-by-four", ("case", "x"), (2, 4)),
    ("two-by-four", ("x", "case"), (4, 2)),
    ("two-by-four", ("case", "x", "y"), (2, 2, 2)),
    ("interleaved", ("case", "x"), (2, 4)),
    ("three-granules", ("case",), (3,)),
])
def test_multi_granule_placement_matches_jax(fleet, axes, shape):
    devs = FLEETS[fleet]
    if fleet == "three-granules":  # one device of each granule
        devs = [devs[1], devs[2], devs[0]]
    got = tma.create_hybrid_mesh(axes, shape, devs)
    want = jma.create_hybrid_mesh(axes, shape, devs)
    assert got.devices.shape == want.devices.shape == shape
    assert [d.id for d in got.devices.flat] == [d.id for d in want.devices.flat]
    assert tma.mesh_axis_network(got) == jma.mesh_axis_network(want)


@pytest.mark.parametrize("fleet,axes,shape", [
    ("two-by-four", ("x", "y"), (2, 4)),       # a spatial mesh across granules
    ("two-by-four", ("case", "x"), (4, 2)),    # more cases than granules
])
def test_multi_granule_refusals_in_the_jax_words(fleet, axes, shape):
    devs = FLEETS[fleet]
    with pytest.raises(ValueError) as mine:
        tma.create_hybrid_mesh(axes, shape, devs)
    with pytest.raises(ValueError) as theirs:
        jma.create_hybrid_mesh(axes, shape, devs)
    assert str(mine.value) == str(theirs.value)


def test_uneven_granules_and_rank_refusals():
    with pytest.raises(ValueError, match="granule 0 holds 3 devices"):
        tma.create_hybrid_mesh(("case", "x"), (2, 4), FLEETS["uneven-3-5"])
    for call in (lambda m: m.create_hybrid_mesh(("x",), (2, 2), device_list("cpu", 4)),
                 lambda m: m.create_hybrid_mesh(("x", "y"), (4, 4), device_list("cpu", 4)),
                 lambda m: m.axis_rule("x", {"x": "nvlink"})):
        with pytest.raises(ValueError) as mine:
            call(tma)
        assert str(mine.value)
    with pytest.raises(ValueError) as theirs:
        jma.axis_rule("x", {"x": "nvlink"})
    assert str(theirs.value) == "axis rule for 'x' must be one of ('ici', 'dcn'), got 'nvlink'"
    with pytest.raises(ValueError) as mine:
        tma.axis_rule("x", {"x": "nvlink"})
    assert str(mine.value) == str(theirs.value)
    assert tma.DEFAULT_AXIS_RULES == jma.DEFAULT_AXIS_RULES


# ---------------------------------------------------------------------------
# solve_case_sharded against the JAX function and the port's own solver
# ---------------------------------------------------------------------------


def _case(n, nt, seed, test=False, dt=1e-5, eps=2, dh=None):
    rng = np.random.default_rng(seed)
    return EnsembleCase(shape=(n, n), nt=nt, eps=eps, k=1.0, dt=dt,
                        dh=1.0 / n if dh is None else dh, test=test,
                        u0=None if test else rng.normal(size=(n, n)))


def _jcase(c):
    return jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                             test=c.test, u0=c.u0)


SHARDED = {
    "euler-24-2": (_case(24, 3, 1), dict(method="sat"), 2),
    "euler-32-4-test": (_case(32, 4, 2, test=True, dt=1e-4, dh=0.02), dict(method="sat"), 4),
    "rkc-24-4": (_case(24, 3, 3, dt=2e-4, dh=0.01), dict(method="sat", stepper="rkc",
                                                         stages=4), 4),
    "rkc-32-2-test": (_case(32, 2, 4, test=True, dt=4e-4, dh=0.02),
                      dict(method="sat", stepper="rkc", stages=4), 2),
    "fft-32-2": (_case(32, 3, 5, eps=3), dict(method="fft"), 2),
    "fft-24-4-test": (_case(24, 2, 6, test=True, dt=1e-4, dh=0.02),
                      dict(method="fft"), 4),
}


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_solve_case_sharded_matches_jax_and_the_offline_solver(name):
    case, kw, n = SHARDED[name]
    got, info = solve_case_sharded(case, ndevices=n, comm="fused", device="cpu", **kw)
    want, jinfo = jgang.solve_case_sharded(_jcase(case), ndevices=n, comm="fused", **kw)
    assert got.dtype == np.float64 and got.shape == case.shape
    assert np.isfinite(got).all()
    assert np.abs(got - np.asarray(want)).max() <= 1e-12, name
    # method sat/fft is not cuda: fused refuses, the collective transport
    # serves — recorded in both packages
    assert info["comm"] == jinfo["comm"] == "collective"
    assert info["mesh"] == jinfo["mesh"] and info["devices"] == jinfo["devices"] == n
    assert info["axes"] == jinfo["axes"] == {"x": "ici", "y": "ici"}
    assert info.get("stepper") == jinfo.get("stepper")
    if case.test:
        assert abs(info["error_l2"] - jinfo["error_l2"]) <= 1e-12
    # bitwise the port's own distributed solve on the same mesh
    mesh = choose_mesh_for_grid(*case.shape, device_list("cpu", n))
    mx, my = mesh.shape["x"], mesh.shape["y"]
    s = Solver2DDistributed(case.shape[0] // mx, case.shape[1] // my, mx, my, case.nt,
                            case.eps, k=case.k, dt=case.dt, dh=case.dh, mesh=mesh,
                            comm="collective", **kw)
    s.test_init() if case.test else s.input_init(case.u0)
    assert np.array_equal(np.asarray(s.do_work(), np.float64), got)


def test_gang_fused_engages_on_cuda_and_is_bitwise_collective():
    case = _case(16, 3, 0, test=True, dt=1e-4, dh=0.02)
    vf, inf = solve_case_sharded(case, ndevices=4, comm="fused", method="cuda", device="cpu")
    vc, inc = solve_case_sharded(case, ndevices=4, comm="collective", method="cuda",
                                 device="cpu")
    assert (inf["comm"], inc["comm"]) == ("fused", "collective")
    assert inf["transport"] == "interp" and "transport" not in inc  # the CPU: band copies
    assert np.array_equal(vf, vc)
    assert inf["error_l2"] / (16 * 16) <= 1e-6
    assert inf["mesh"] == [1, 4] and inf["axes"] == {"x": "ici", "y": "ici"}


def test_gang_solver_cache_is_bounded_lru(monkeypatch):
    assert GANG_SOLVER_CACHE_CAP == jgang.GANG_SOLVER_CACHE_CAP
    cache: dict = {}
    cases = [_case(24, 2 + i, 0, test=True) for i in range(3)]
    outs = [solve_case_sharded(c, ndevices=2, method="sat", solver_cache=cache,
                               cache_cap=2, device="cpu")[0] for c in cases]
    assert len(cache) == 2  # the oldest signature evicted
    key = next(iter(cache))
    assert key[10] == "float64" or key[10] is None
    again = solve_case_sharded(cases[0], ndevices=2, method="sat", solver_cache=cache,
                               cache_cap=2, device="cpu")[0]
    assert np.array_equal(again, outs[0])
    # a hit moves to the back (LRU recency) and reuses the solver
    solver = cache[list(cache)[-1]][0]
    solve_case_sharded(cases[0], ndevices=2, method="sat", solver_cache=cache, cache_cap=2,
                       device="cpu")
    assert cache[list(cache)[-1]][0] is solver
    # the dtype slot holds the torch dtype's name
    c32: dict = {}
    solve_case_sharded(cases[0], ndevices=2, method="sat", solver_cache=c32,
                       dtype=torch.float32, device="cpu")
    assert next(iter(c32))[10] == "float32"
    # NLHEAT_GANG_SOLVER_CAP bounds it when cache_cap is not given
    monkeypatch.setenv("NLHEAT_GANG_SOLVER_CAP", "1")
    env: dict = {}
    for c in cases[:2]:
        solve_case_sharded(c, ndevices=2, method="sat", solver_cache=env, device="cpu")
    assert len(env) == 1


def test_solve_case_sharded_refusals_in_the_jax_words():
    ok = _case(24, 3, 1)
    prod = _case(24, 3, 1)
    prod.u0 = None
    jprod = _jcase(ok)
    jprod.u0 = None
    test_u0 = _case(24, 3, 1, test=True)
    test_u0.u0 = np.zeros((24, 24))
    calls = [
        (lambda: solve_case_sharded(EnsembleCase(shape=(8,), nt=2, eps=1, k=1.0, dt=1e-5,
                                                 dh=0.1), ndevices=2, device="cpu"),
         lambda: jgang.solve_case_sharded(jens.EnsembleCase(shape=(8,), nt=2, eps=1, k=1.0,
                                                            dt=1e-5, dh=0.1), ndevices=2)),
        (lambda: solve_case_sharded(ok, comm="bogus", device="cpu"),
         lambda: jgang.solve_case_sharded(_jcase(ok), comm="bogus")),
        (lambda: solve_case_sharded(prod, ndevices=2, method="sat", device="cpu"),
         lambda: jgang.solve_case_sharded(jprod, ndevices=2, method="sat")),
        (lambda: solve_case_sharded(test_u0, ndevices=2, method="sat", device="cpu"),
         lambda: jgang.solve_case_sharded(_jcase(test_u0), ndevices=2, method="sat")),
        (lambda: solve_case_sharded(ok, ndevices=2, method="sat", solver_cache={},
                                    cache_cap=-1, device="cpu"),
         lambda: jgang.solve_case_sharded(_jcase(ok), ndevices=2, method="sat",
                                          solver_cache={}, cache_cap=-1)),
    ]
    for mine, theirs in calls:
        with pytest.raises(ValueError) as a:
            mine()
        with pytest.raises(ValueError) as b:
            theirs()
        assert str(a.value) == str(b.value)


def test_sharded_fft_capability_matches_jax():
    from nonlocalheatequation_torch.serve.router import ReplicaRouter
    from nonlocalheatequation_tpu.serve.router import ReplicaRouter as JRouter

    class Stub:
        gang_devices = 8

    class NoGang:
        gang_devices = None

    for stub in (Stub(), NoGang()):
        for shape, eps in (((64, 64), 3), ((64, 64, 64), 3), ((65, 64), 3), ("bad", 3),
                           ((32, 32), 5), ((48, 16), 2), ((4096, 4096), 8)):
            assert ReplicaRouter.sharded_fft_capability(stub, shape, eps) == \
                JRouter.sharded_fft_capability(stub, shape, eps), (stub, shape)


# ---------------------------------------------------------------------------
# the gang replica behind the router (real worker processes)
# ---------------------------------------------------------------------------


def _offline(c, **kw):
    return solve_case_sharded(c, ndevices=4, comm="fused", device="cpu", **kw)[0]


def test_gang_replica_over_pipe_and_tcp_bitwise_offline():
    from nonlocalheatequation_torch.serve.router import ReplicaRouter

    small = [_case(16, 3, 9)]
    big = [_case(24, 3 + i, 10 + i) for i in range(2)]
    rkc_case = _case(24, 2, 12, dt=2e-4, dh=0.01)
    fft_case = _case(32, 2, 13, eps=3)
    want_big = [_offline(c, method="sat") for c in big]
    want_rkc = _offline(rkc_case, method="sat", stepper="rkc", stages=4)
    want_fft = _offline(fft_case, method="fft")
    rkc = EngineChoice("rkc", 4, "sat", "f32", rkc_case.dt, rkc_case.nt, 1.0, 0.0, "analytic")
    fft = EngineChoice("euler", 0, "fft", "f32", fft_case.dt, fft_case.nt, 1.0, 0.0,
                       "analytic")
    kw = dict(method="sat", batch_sizes=(1,), device="cpu", dtype=torch.float64,
              shard_threshold=16 * 16, gang_devices=4, spawn_timeout_s=120)
    # pipes: the picked stepper and method ride the case frame to the gang
    with ReplicaRouter(replicas=1, **kw) as router:
        assert router.is_sharded((24, 24)) and not router.is_sharded((16, 16))
        assert not router.is_sharded((24, 24, 24))
        hs = [router.submit(c) for c in small + big]
        h_rkc = router.submit(rkc_case, engine=rkc)
        h_fft = router.submit(fft_case, engine=fft)
        router.drain(timeout_s=300)
        for h, w in zip(hs[1:] + [h_rkc, h_fft], want_big + [want_rkc, want_fft],
                        strict=True):
            assert h.error is None and np.array_equal(h.wait(60), w)
        assert hs[0].error is None and hs[0].result.shape == (16, 16)
        m = router.metrics()
        assert m["sharded_cases"] == 4 and m["deaths"] == 0 and len(m["gang"]) == 1
        stats = router.refresh_stats()
        gid = m["gang"][0]
        assert stats[gid].get("gang") is True and stats[gid]["metrics"]["cases"] == 4
        assert stats[gid]["metrics"]["comm"] == {"collective": 4}
        assert router._telemetry.rate(gid) == 0.0  # out of the scale policy
        with pytest.raises(ValueError, match="gang replica"):
            router.drain_replica(gid)
    # TCP: die@1 kills the gang with the first sharded case in flight; the
    # gang respawns and the case is re-served bitwise over the socket
    with ReplicaRouter(replicas=1, transport="tcp", faults="die@1", respawn=True,
                       **kw) as router:
        hs = [router.submit(c) for c in small + big]
        router.drain(timeout_s=300)
        m = router.metrics()
        assert m["transport"] == "tcp" and m["deaths"] == 1 and m["requeued"] >= 1
        assert m["sharded_cases"] == 2 and len(m["gang"]) == 1
        for h, w in zip(hs[1:], want_big, strict=True):
            assert h.error is None and np.array_equal(h.result, w)
    assert not torch.cuda.is_initialized()
