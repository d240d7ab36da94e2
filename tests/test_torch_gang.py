"""The port's gang-scheduled stretches (parallel/gang.py) and the elastic
executor's checkpoints, against the JAX package's on the CPU.

The gang runs every step outside a measured window from fixed slot stacks:
it is BITWISE the executor's per-tile rectangle walk (the same frames, the
same epilogue), its pad slots stay zero, its stretches cover every step and stop where the JAX executor's
do; the general (eps > tile) gang is bitwise the per-tile rectangle walk;
the superstep gang is within 1e-12 of the per-step runs and refuses where it
could not engage.  A run resumed from a checkpoint equals the uninterrupted
run bitwise, and checkpoints cross between the packages in both directions
(the same .npz format), each resumed run within 1e-12 of the other
package's uninterrupted one.  float64, virtual CPU devices, ``method="cuda"``
(the plain ``nsum2d`` on the CPU); the JAX executor runs its default
``shift`` on the suite's virtual devices.
"""

import numpy as np
import pytest

import jax
import torch

from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.parallel import gang as tgang
from nonlocalheatequation_torch.parallel.elastic import ElasticSolver2D
from nonlocalheatequation_torch.parallel.mesh import device_list
from nonlocalheatequation_torch.utils.checkpoint import load_state
from nonlocalheatequation_tpu.parallel import gang as jgang
from nonlocalheatequation_tpu.parallel.elastic import ElasticSolver2D as JElastic
from nonlocalheatequation_tpu.utils import checkpoint as jckpt

DEVS = device_list("cpu", 4)


class _PerTile(ElasticSolver2D):
    """Every step through the rectangle walk: no gang stretch."""

    def _gang_stretch_len(self, t, measured):
        return 0


def _solver(devices=DEVS, cls=ElasticSolver2D, **kw):
    for key, val in (("k", 1.0), ("dt", 1e-5), ("dh", 0.02), ("nlog", 1000)):
        kw.setdefault(key, val)
    return cls(devices=devices, method="cuda", **kw)


def _run(gang=True, devices=DEVS, u0=None, **kw):
    s = _solver(devices, ElasticSolver2D if gang else _PerTile, **kw)
    s.test_init() if u0 is None else s.input_init(u0)
    s.do_work()
    return s


def _oracle(n, nt, eps, **kw):
    o = Solver2D(n, n, nt, eps, device="cpu", method="cuda", **kw)
    o.test_init()
    o.do_work()
    return o.u


def test_gang_bitwise_the_batched_path_and_the_jax_gang():
    kw = dict(nx=6, ny=6, npx=4, npy=4, nt=12, eps=2)
    a, b = _run(True, **kw), _run(False, **kw)
    assert a._gang is not None and b._gang is None
    assert np.array_equal(a.u, b.u) and a.error_l2 == b.error_l2
    j = JElastic(k=1.0, dt=1e-5, dh=0.02, nlog=1000, devices=jax.devices()[:4], **kw)
    j.test_init()
    j.do_work()
    assert np.abs(a.u - np.asarray(j.u)).max() < 1e-12
    assert np.abs(a.u - _oracle(24, 12, 2, k=1.0, dt=1e-5, dh=0.02)).max() < 1e-12


def test_gang_plan_equals_jax():
    a = np.array([[0, 1, 1], [1, 2, 1], [0, 0, 1]], dtype=np.int64)
    for floor in (0, 9):
        ours, theirs = tgang.GangPlan(a, 4, t_max_floor=floor), jgang.GangPlan(a, 4, floor)
        assert ours.order == theirs.order and ours.t_max == theirs.t_max
        assert ours.zero_slot == theirs.zero_slot and np.array_equal(ours.idx, theirs.idx)
    tiles = {k: np.full((2, 3), 1.0 + 3 * k[0] + k[1]) for k in np.ndindex(3, 3)}
    ours = tgang.GangPlan(a, 4, t_max_floor=6)
    state = ours.pack(tiles, 2, 3, torch.float64, device_list("cpu", 4))
    packed = jgang.GangPlan(a, 4, 6).pack(tiles, 2, 3, np.float64)
    assert np.array_equal(np.stack([s.numpy() for s in state]), packed)
    assert {k: v.numpy().tolist() for k, v in ours.unpack(state).items()} == {
        k: v.tolist() for k, v in tiles.items()}


def test_gang_pad_slots_stay_zero_and_t_max_is_reused():
    a = np.ones((4, 4), dtype=np.int64)
    a[0, 0] = 0  # device 0: 1 tile, device 1: 15 -> T_max = 15
    s = _run(nx=6, ny=6, npx=4, npy=4, nt=6, eps=2, dh=0.04, assignment=a,
             devices=device_list("cpu", 2))
    gang = s._gang
    assert gang.plan.t_max == 15
    for d, own in gang.plan.order.items():
        assert (gang._state[d][len(own):] == 0).all()
    # a migration that shrinks the largest region keeps T_max (t_max_floor)
    gang.s.assignment = np.zeros((4, 4), dtype=np.int64)
    gang.s.assignment[:2] = 1
    gang.rebuild(gang.tiles(), None)
    assert gang.plan.t_max == 15 and (gang._state[0][8:] == 0).all()


@pytest.mark.parametrize("kw", [
    dict(nbalance=10, measure_window=3),
    dict(nbalance=8),
    dict(checkpoint_path="unused.npz", ncheckpoint=6),
    dict(nlog=5),
    dict(nbalance=7, nlog=4, checkpoint_path="unused.npz", ncheckpoint=5),
])
def test_stretch_lengths_cover_every_step_as_in_jax(kw):
    ours = _solver(nx=4, ny=4, npx=2, npy=2, nt=20, eps=2, k=0.2, dt=5e-4, **kw)
    theirs = JElastic(4, 4, 2, 2, nt=20, eps=2, k=0.2, dt=5e-4, dh=0.02,
                      devices=jax.devices()[:4], **{"nlog": 1000, **kw})
    if "nlog" in kw:
        ours.logger = theirs.logger = lambda t, u: None
    for measured in (True, False):
        covered, t = [], 0
        while t < 20:
            n = ours._gang_stretch_len(t, measured)
            assert n == theirs._gang_stretch_len(t, measured)
            assert ours._in_measure_window(t) == theirs._in_measure_window(t)
            assert ours._rebalance_due(t) == theirs._rebalance_due(t)
            covered += list(range(t, t + max(n, 1)))
            t += max(n, 1)
        assert covered == list(range(20))


def test_gang_logger_barriers_with_an_imbalanced_map():
    a = np.ones((5, 5), dtype=np.int64)
    a[0, 0] = 0
    logged = []
    s = _run(nx=5, ny=5, npx=5, npy=5, nt=12, eps=2, nlog=5, dh=0.04, assignment=a,
             devices=device_list("cpu", 2))
    assert s.u is not None
    s.logger = lambda t, u: logged.append((t, u.copy()))
    s.test_init()
    s.do_work()
    assert [t for t, _ in logged] == [0, 5, 10]
    assert np.abs(s.u - _oracle(25, 12, 2, k=1.0, dt=1e-5, dh=0.04)).max() < 1e-12
    assert np.abs(dict(logged)[5] - _oracle(25, 6, 2, k=1.0, dt=1e-5, dh=0.04)).max() < 1e-12


@pytest.mark.parametrize("nx,npx,eps", [(4, 5, 6), (1, 10, 5)])
def test_general_gang_bitwise_the_per_tile_walk(nx, npx, eps):
    kw = dict(nx=nx, ny=nx, npx=npx, npy=npx, nt=6, eps=eps, dh=0.05)
    a, b = _run(True, **kw), _run(False, **kw)
    assert not a._use_fused and a._gang.plan is not None and b._gang is None
    assert np.array_equal(a.u, b.u)
    n = nx * npx
    assert np.abs(a.u - _oracle(n, 6, eps, k=1.0, dt=1e-5, dh=0.05)).max() < 1e-12
    assert a.error_l2 / n**2 <= 1e-6


def test_superstep_within_1e12_of_the_per_step_gang(monkeypatch):
    built = []
    real = tgang.make_gang_run_superstep
    monkeypatch.setattr(tgang, "make_gang_run_superstep",
                        lambda *a, **kw: built.append(a[6]) or real(*a, **kw))
    kw = dict(nx=8, ny=8, npx=3, npy=3, nt=11, eps=2)
    base = _run(**kw)
    for K in (2, 3):
        s = _run(superstep=K, **kw)
        assert np.abs(s.u - base.u).max() < 1e-12
        assert s.error_l2 / 576 <= 1e-6
    assert built == [2, 3]
    # with windows, rebalances, logs and checkpoints between the blocks
    logs = []
    s = _run(superstep=2, nbalance=8, logger=lambda t, u: logs.append(t), nlog=7,
             nx=8, ny=8, npx=3, npy=3, nt=24, eps=2)
    assert logs == [0, 7, 14, 21]
    assert np.abs(s.u - _run(nx=8, ny=8, npx=3, npy=3, nt=24, eps=2).u).max() < 1e-12
    # the free-decay path
    u0 = np.random.default_rng(5).normal(size=(24, 24))
    assert np.abs(_run(u0=u0, superstep=2, **kw).u - _run(u0=u0, **kw).u).max() < 1e-12


def test_superstep_refusals():
    with pytest.raises(ValueError, match="tile edge"):
        _solver(nx=5, ny=5, npx=5, npy=5, nt=4, eps=2, superstep=3)
    for attrs, kw, match in ((dict(measure=True), {}, "measured window"),
                             ({}, dict(nbalance=5, nt=12), "window-free")):
        s = _solver(**{**dict(nx=6, ny=6, npx=3, npy=3, nt=4, eps=3, superstep=2), **kw})
        for name, val in attrs.items():
            setattr(s, name, val)
        s.test_init()
        with pytest.raises(RuntimeError, match=match):
            s.do_work()


def test_resumed_runs_equal_uninterrupted_runs(tmp_path):
    """Gang, per-step and superstep runs stopped after step 8 and resumed
    from the checkpoint written at t=6 land bitwise where the uninterrupted
    run lands (the superstep within 1e-12 across schedules)."""
    kw = dict(nx=8, ny=8, npx=3, npy=3, nt=16, eps=2)
    full = _run(**kw)
    for gang, k_write, k_resume in ((True, 1, 1), (False, 1, 1), (True, 2, 1), (True, 1, 3)):
        path = str(tmp_path / f"c{gang}{k_write}{k_resume}.npz")
        cls = ElasticSolver2D if gang else _PerTile
        w = _solver(cls=cls, checkpoint_path=path, ncheckpoint=6, superstep=k_write, **kw)
        w.test_init()
        w.nt = 9
        w.do_work()
        r = _solver(cls=cls, superstep=k_resume, **kw)
        r.test_init()
        r.resume(path)
        assert r.t0 == 6
        r.do_work()
        if k_write == k_resume == 1:
            assert np.array_equal(r.u, full.u)
        else:
            assert np.abs(r.u - full.u).max() < 1e-12


def test_checkpoints_cross_the_packages(tmp_path):
    """The case of tests/test_checkpoint.py (elastic, interrupted at 8 of
    16 steps) in both packages, and each package resuming the other's file."""
    kw = dict(nx=5, ny=5, npx=4, npy=4, eps=3, k=0.2, dt=1e-4, dh=0.05)

    def ours(nt, **extra):
        return ElasticSolver2D(nt=nt, devices=DEVS, method="cuda", **kw, **extra)

    def theirs(nt, **extra):
        return JElastic(nt=nt, devices=jax.devices()[:4], **kw, **extra)

    results, files = {}, {}
    for name, make in (("torch", ours), ("jax", theirs)):
        full = make(16)
        full.test_init()
        full.do_work()
        path = str(tmp_path / f"{name}.npz")
        first = make(16, checkpoint_path=path, ncheckpoint=8)
        first.test_init()
        first.nt = 8
        first.do_work()
        results[name], files[name] = np.asarray(full.u), path
    for name, make in (("torch", ours), ("jax", theirs)):
        for src in ("torch", "jax"):
            r = make(16)
            r.test_init()
            r.resume(files[src])
            assert r.t0 == 8
            r.do_work()
            if src == name:
                assert np.array_equal(np.asarray(r.u), results[name])
            assert np.abs(np.asarray(r.u) - results[name]).max() < 1e-12
    (tu, tt, tp), (ju, jt, jp) = load_state(files["torch"]), jckpt.load_state(files["jax"])
    assert tt == jt == 8 and tp == jp and tu.dtype == ju.dtype == np.float64
    assert np.abs(tu - ju).max() < 1e-12
