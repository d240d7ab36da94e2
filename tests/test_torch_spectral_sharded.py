"""The port's sharded spectral tier (ops/spectral_sharded.py,
parallel/spectral_halo.py under the distributed solvers' ``method="fft"``)
against the JAX package's on the CPU.

The JAX solvers run on the suite's 8 virtual CPU devices (tests/conftest.py),
as tests/test_spectral_sharded.py runs them; the port's meshes hold the same
shapes of virtual CPU devices.  Inputs are seeded NumPy arrays.

Tolerances: plans, schedules, padded shapes, tables, gates and traffic counts
equal the JAX package's; the sharded forward transform against NumPy's
``rfftn`` on the zero-collar box, the round trip, the sharded neighbour sum
and the distributed euler/rkc/expo (S = 0, 1, 2) solves against the port's
and the JAX package's serial fft solves and the JAX distributed solves: 1e-12
relative (float64); the manufactured contract error_l2/#points <= 1e-6; two
fresh solves bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax

from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.obs.metrics import REGISTRY as TREG
from nonlocalheatequation_torch.ops import spectral_sharded as tss
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
from nonlocalheatequation_torch.ops.spectral import neighbor_sum_fft_np
from nonlocalheatequation_torch.parallel import distributed2d as td2
from nonlocalheatequation_torch.parallel import distributed3d as td3
from nonlocalheatequation_torch.parallel import spectral_halo as tsh
from nonlocalheatequation_torch.parallel.mesh import (
    device_list,
    fetch_global,
    make_mesh,
    make_mesh_3d,
    map_blocks,
    put_global,
)
from nonlocalheatequation_tpu.ops import spectral_sharded as jss
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JOp2D
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp3D as JOp3D
from nonlocalheatequation_tpu.parallel import distributed2d as jd2
from nonlocalheatequation_tpu.parallel import distributed3d as jd3
from nonlocalheatequation_tpu.parallel import mesh as jmesh
from nonlocalheatequation_tpu.parallel import spectral_halo as jsh
from tests.cases import L2_THRESHOLD

torch.set_num_threads(1)
DEVS = device_list("cpu", 8)
F64 = torch.float64


def _mesh(ms):
    return make_mesh(*ms, DEVS) if len(ms) == 2 else make_mesh_3d(*ms, devices=DEVS)


def _oracle(u, plan):
    """NumPy's rfftn on the zero-collar box, padded to the plan's layout."""
    up = np.zeros(plan.box)
    up[tuple(slice(0, s) for s in u.shape)] = u
    F = np.fft.rfftn(up)
    return np.pad(F, [(0, g - s) for s, g in zip(F.shape, plan.freq_global_shape)])


def _fwd_inv(u, plan):
    blocks = put_global(u, _mesh(plan.mesh_shape), F64)
    h = plan.fwd(blocks)
    return plan.fetch_freq(h), fetch_global(plan.inv(h))


# -- the plan against the JAX plan, the transform against rfftn ----------------------------

@pytest.mark.parametrize("shape,eps,ms", [((16, 24), 3, (4, 2)), ((16, 24), 3, (2, 4)),
                                          ((16, 24), 3, (8, 1)), ((16, 22), 3, (4, 2)),
                                          ((8, 12, 10), 2, (2, 2, 2)),
                                          ((16, 8, 12), 3, (2, 1, 4))])
def test_plan_matches_jax_and_fwd_matches_the_rfftn_oracle(shape, eps, ms):
    plan = tss.get_plan(shape, eps, ms)
    jplan = jss.get_plan(shape, eps, ms)
    assert plan.box == jplan.box
    assert plan.freq_global_shape == jplan.freq_global_shape
    assert plan.a2a_schedule() == jplan.a2a_schedule()
    assert plan.freq_spec == tuple(jplan.freq_spec)
    u = np.random.default_rng(7).standard_normal(shape)
    h, rt = _fwd_inv(u, plan)
    F = _oracle(u, plan)
    assert np.abs(h - F).max() / np.abs(F).max() <= 1e-12
    assert np.abs(rt - u).max() <= 1e-12


def test_fwd_on_an_odd_box():
    # eps 3 on NY=22: y box 25 (odd): the (n+1)//2 bins and the padding to 8 bite
    plan = tss.get_plan((16, 22), 3, (4, 2))
    assert plan.box[1] % 2 == 1 and plan.freq_global_shape == (20, 16)
    u = np.random.default_rng(11).standard_normal((16, 22))
    h, rt = _fwd_inv(u, plan)
    F = _oracle(u, plan)
    assert np.abs(h - F).max() / np.abs(F).max() <= 1e-12
    assert np.abs(rt - u).max() <= 1e-12


def test_put_freq_is_the_inverse_of_fetch_freq():
    plan = tss.get_plan((8, 12, 10), 2, (2, 2, 2))
    arr = np.random.default_rng(3).standard_normal(plan.freq_global_shape)
    blocks = plan.put_freq(arr, _mesh((2, 2, 2)).devices, F64)
    assert np.array_equal(plan.fetch_freq(blocks), arr)


def test_sharded_neighbor_sum_matches_the_np_oracle():
    NX, NY, eps = 16, 24, 3
    op = NonlocalOp2D(eps, 1.0, 5e-4, 0.02, method="fft")
    plan = tss.get_plan((NX, NY), eps, (4, 2))
    mesh = _mesh((4, 2))
    sig = plan.put_freq(plan.neighbor_symbol_padded(op.weights), mesh.devices, F64)
    u = np.random.default_rng(17).standard_normal((NX, NY))
    ns = plan.inv(map_blocks(lambda h, s: h * s, plan.fwd(put_global(u, mesh, F64)), sig))
    got, want = fetch_global(ns), neighbor_sum_fft_np(op, u)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-12


@pytest.mark.parametrize("stepper,stages", [("euler", 0), ("rkc", 4), ("expo", 0),
                                            ("expo", 2)])
def test_spectral_tables_equal_the_jax_tables(stepper, stages):
    plan = tss.get_plan((16, 24), 3, (4, 2))
    jplan = jss.get_plan((16, 24), 3, (4, 2))
    op = NonlocalOp2D(3, 1.0, 1e-3, 0.02, method="fft")
    jop = JOp2D(3, 1.0, 1e-3, 0.02, method="fft")
    ours = tsh.spectral_tables(op, plan, stepper, stages)
    theirs = jsh.spectral_tables(jop, jplan, np.float64, stepper, stages)
    assert len(ours) == len(theirs) == tsh.ntables(stepper, stages)
    for a, b in zip(ours, theirs, strict=True):
        assert np.array_equal(a, np.asarray(b))


# -- the distributed spectral solves -----------------------------------------------------

def _serial2d(stepper, stages, dt, nt):
    s = Solver2D(24, 24, nt, 3, method="fft", stepper=stepper, stages=stages, dt=dt,
                 device="cpu", dtype=F64)
    s.test_init()
    s.do_work()
    return s


def _dist2d(stepper, stages, dt, nt, mx, my):
    d = td2.Solver2DDistributed(24 // mx, 24 // my, mx, my, nt, 3, method="fft",
                                stepper=stepper, stages=stages, dt=dt, mesh=_mesh((mx, my)),
                                dtype=F64)
    d.test_init()
    d.do_work()
    return d


@pytest.mark.parametrize("stepper,stages,dt", [("euler", 0, 5e-4), ("rkc", 4, 2e-3),
                                               ("expo", 0, 1e-3), ("expo", 1, 1e-3),
                                               ("expo", 2, 1e-3)])
def test_distributed_fft_steppers_match_serial_and_jax_2d(stepper, stages, dt):
    s = _serial2d(stepper, stages, dt, nt=5)
    for mx, my in ((4, 2), (2, 4), (8, 1)):
        d = _dist2d(stepper, stages, dt, 5, mx, my)
        rel = np.abs(d.u - s.u).max() / np.abs(s.u).max()
        assert rel <= 1e-12, (mx, my, rel)
    j = jd2.Solver2DDistributed(6, 12, 4, 2, 5, 3, method="fft", stepper=stepper,
                                stages=stages, dt=dt, mesh=jmesh.make_mesh(4, 2))
    j.test_init()
    j.do_work()
    assert np.abs(np.asarray(j.u) - d.u).max() / np.abs(s.u).max() <= 1e-12


@pytest.mark.parametrize("stepper,stages", [("euler", 0), ("rkc", 4), ("expo", 0),
                                            ("expo", 1)])
def test_distributed_fft_steppers_match_serial_and_jax_3d(stepper, stages):
    N = (8, 12, 10)
    kw = dict(method="fft", stepper=stepper, stages=stages, dt=5e-4, dh=0.05)
    s = Solver3D(*N, 4, 2, device="cpu", dtype=F64, **kw)
    d = td3.Solver3DDistributed(*N, 4, 2, mesh=_mesh((2, 2, 2)), dtype=F64, **kw)
    j = jd3.Solver3DDistributed(*N, 4, 2, mesh=jmesh.make_mesh_3d(2, 2, 2,
                                                                   devices=jax.devices()),
                                **kw)
    for x in (s, d, j):
        x.test_init()
        x.do_work()
    scale = np.abs(s.u).max()
    assert np.abs(d.u - s.u).max() / scale <= 1e-12
    assert np.abs(d.u - np.asarray(j.u)).max() / scale <= 1e-12


def test_distributed_fft_production_path_and_the_checkpoint(tmp_path):
    # input_init (no source) and a checkpoint written halfway, resumed
    u0 = np.random.default_rng(5).normal(size=(24, 24))
    s = Solver2D(24, 24, 6, 3, method="fft", stepper="expo", stages=1, dt=1e-3, device="cpu",
                 dtype=F64)
    s.input_init(u0)
    want = s.do_work()
    kw = dict(method="fft", stepper="expo", stages=1, dt=1e-3, mesh=_mesh((4, 2)), dtype=F64)
    w = td2.Solver2DDistributed(6, 12, 4, 2, 3, 3, checkpoint_path=str(tmp_path / "c.npz"),
                                ncheckpoint=3, **kw)
    w.input_init(u0)
    w.do_work()
    r = td2.Solver2DDistributed(6, 12, 4, 2, 6, 3, **kw)
    r.input_init(u0)
    r.resume(str(tmp_path / "c.npz"))
    assert r.t0 == 3
    assert np.abs(r.do_work() - want).max() / np.abs(want).max() <= 1e-12


def test_distributed_fft_manufactured_contract():
    d = _dist2d("euler", 0, 1e-4, 20, 4, 2)
    assert d.error_l2 / (24 * 24) <= L2_THRESHOLD
    d = _dist2d("expo", 2, 2e-4, 10, 4, 2)
    assert d.error_l2 / (24 * 24) <= L2_THRESHOLD


def test_distributed_fft_bitwise_deterministic():
    a = _dist2d("expo", 2, 1e-3, 5, 4, 2)
    b = _dist2d("expo", 2, 1e-3, 5, 4, 2)
    assert np.array_equal(a.u, b.u)


# -- the gate and the refusals -----------------------------------------------------------

GATE = [((16, 24), 3, (4, 2)), ((16, 24), 3, (1, 1)), ((8, 12, 10), 2, (2, 2, 2)),
        ((10, 10), 3, (2, 2)), ((16, 25), 3, (4, 5)), ((16, 24), 3, (2, 2, 2)),
        ((64,), 3, (8,)), ((12, 12), 2, (3, 2)), ((12, 8, 8), 2, (2, 2, 3))]


@pytest.mark.parametrize("killed", [False, True])
def test_supports_sharded_fft_table_equals_jax(monkeypatch, killed):
    if killed:
        monkeypatch.setenv("NLHEAT_FFT_SHARDED", "0")
    for shape, eps, ms in GATE:
        assert tss.supports_sharded_fft(shape, eps, ms) == jss.supports_sharded_fft(
            shape, eps, ms), (shape, ms)
    assert tss.supports_sharded_fft((16, 24), 3, (4, 2)) is not killed


def test_require_sharded_fft_refusals(monkeypatch):
    with pytest.raises(ValueError, match="pencil"):
        tss.require_sharded_fft((10, 10), 3, (2, 2))
    monkeypatch.setenv("NLHEAT_FFT_SHARDED", "0")
    with pytest.raises(ValueError, match="kill-switch"):
        tss.require_sharded_fft((16, 24), 3, (4, 2))


def test_solver_ctor_refusals(monkeypatch):
    with pytest.raises(ValueError, match="pencil"):
        td2.Solver2DDistributed(6, 12, 4, 2, 5, 3, method="fft", comm="fused",
                                mesh=_mesh((4, 2)))
    with pytest.raises(ValueError, match="superstep"):
        td2.Solver2DDistributed(6, 12, 4, 2, 5, 3, method="fft", superstep=2,
                                mesh=_mesh((4, 2)))
    with pytest.raises(ValueError, match="pencil"):
        td2.Solver2DDistributed(5, 5, 2, 2, 5, 3, method="fft", mesh=_mesh((2, 2)))
    with pytest.raises(ValueError, match="pencil"):
        td3.Solver3DDistributed(8, 8, 8, 5, 2, method="fft", comm="fused",
                                mesh=_mesh((2, 2, 2)))
    monkeypatch.setenv("NLHEAT_FFT_SHARDED", "0")
    with pytest.raises(ValueError, match="kill-switch"):
        td2.Solver2DDistributed(6, 12, 4, 2, 5, 3, method="fft", mesh=_mesh((4, 2)))


def test_pad_freq_shape_check():
    plan = tss.get_plan((16, 24), 3, (4, 2))
    with pytest.raises(ValueError, match="rfftn layout"):
        plan.pad_freq(np.zeros((3, 3)))


@pytest.mark.parametrize("stepper,stages", [("euler", 0), ("rkc", 4), ("expo", 2)])
def test_spectral_halo_obs_equals_jax(stepper, stages):
    plan = tss.get_plan((16, 24), 3, (4, 2))
    jplan = jss.get_plan((16, 24), 3, (4, 2))
    before = TREG.counter("/halo/bytes").value
    ours = tsh.spectral_halo_obs(plan, stepper, stages, steps=10, itemsize=8,
                                 comm="collective")
    assert ours == jsh.spectral_halo_obs(jplan, stepper, stages, steps=10, itemsize=8,
                                         comm="collective")
    assert ours["transport"] == "alltoall" and ours["devices"] == 8
    assert TREG.counter("/halo/bytes").value - before == (
        ours["rounds"] * ours["bytes_per_device_round"] * 8)


def test_solver_halo_obs_is_the_spectral_schedule():
    d = td2.Solver2DDistributed(6, 12, 4, 2, 5, 3, method="fft", stepper="rkc", stages=4,
                                dt=2e-3, mesh=_mesh((4, 2)), dtype=F64)
    j = jd2.Solver2DDistributed(6, 12, 4, 2, 5, 3, method="fft", stepper="rkc", stages=4,
                                dt=2e-3, mesh=jmesh.make_mesh(4, 2))
    assert d._halo_obs(5) == j._halo_obs(5)
    assert d._halo_obs(5)["rounds"] == 5 * 4


def test_the_op_scale_matches_the_jax_case_scale():
    # the spectral apply's c*h^d host float: the same expression as the JAX one
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp3D, case_scale
    from nonlocalheatequation_tpu.ops.nonlocal_op import case_scale as jcase_scale

    assert case_scale(NonlocalOp2D(3, 0.7, 1e-3, 0.02)) == jcase_scale(
        JOp2D(3, 0.7, 1e-3, 0.02))
    assert case_scale(NonlocalOp3D(2, 0.7, 1e-3, 0.05)) == jcase_scale(
        JOp3D(2, 0.7, 1e-3, 0.05))
