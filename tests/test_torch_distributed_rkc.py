"""The port's distributed stepper tier (parallel/stepper_halo.py under
parallel/distributed2d.py and distributed3d.py, and the distributed CLIs'
stepper flags) against the JAX package's on the CPU.

The JAX solvers run on the suite's 8 virtual CPU devices (tests/conftest.py),
as tests/test_distributed_rkc.py runs them; the port's meshes hold the same
shapes of virtual CPU devices (parallel/mesh.py).  The same seeded NumPy
input goes to both packages.

Tolerances: per-stage distributed rkc is the port's single-device rkc solve
bitwise (the exchange rebuilds each block's neighbourhood and eager torch
runs the same elementwise program; ``method="cuda"`` runs the kernels' plain
versions here), and ``comm="fused"`` is bitwise ``comm="collective"``; every
form (per stage, stage batches, 2D and 3D) holds the JAX distributed solvers
and the single-device solves to 1e-12 (float64); the manufactured contract
error_l2/#points <= 1e-6; the exchange counts are equal.
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax

from nonlocalheatequation_torch import convert
from nonlocalheatequation_torch.cli import solve2d_distributed as tcli
from nonlocalheatequation_torch.cli import solve3d as tcli3
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.obs.metrics import REGISTRY as TREG
from nonlocalheatequation_torch.ops.constants import stable_dt_op
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D
from nonlocalheatequation_torch.parallel import distributed2d as td2
from nonlocalheatequation_torch.parallel import distributed3d as td3
from nonlocalheatequation_torch.parallel import stepper_halo as tsh
from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d
from nonlocalheatequation_torch.utils.checkpoint import load_state
from nonlocalheatequation_tpu.models.solver2d import Solver2D as JSolver2D
from nonlocalheatequation_tpu.parallel import distributed2d as jd2
from nonlocalheatequation_tpu.parallel import distributed3d as jd3
from nonlocalheatequation_tpu.parallel import mesh as jmesh
from nonlocalheatequation_tpu.parallel import stepper_halo as jsh
from tests.cases import L2_THRESHOLD

torch.set_num_threads(1)
CPU = torch.device("cpu")
DEVS = device_list("cpu", 8)
F64 = torch.float64


def rkc_bound(eps, k, dh, stages):
    return stable_dt_op(NonlocalOp2D(eps, k, 1.0, dh), "rkc", stages)


def _run(*solvers, u0=None):
    for s in solvers:
        s.test_init() if u0 is None else s.input_init(u0)
    return [np.asarray(s.do_work(), np.float64) for s in solvers]


def _pair2d(mx, my, n, **kw):
    """(port, JAX) distributed 2D solvers of an n x n grid on an (mx, my) mesh."""
    t = td2.Solver2DDistributed(n // mx, n // my, mx, my, mesh=make_mesh(mx, my, DEVS),
                                dtype=F64, **{"method": "cuda", **kw})
    jkw = {**kw, "method": "conv" if kw.get("method", "cuda") == "cuda" else kw["method"]}
    jkw.pop("comm", None)
    j = jd2.Solver2DDistributed(n // mx, n // my, mx, my, mesh=jmesh.make_mesh(mx, my), **jkw)
    return t, j


# -- per-stage rkc: bitwise the single-device rkc, 1e-12 the JAX solver --------------------

@pytest.mark.parametrize("mx,my", [(4, 2), (2, 4)])
@pytest.mark.parametrize("eps", [2, 7])
def test_perstage_rkc_collective(mx, my, eps):
    # eps 7 on 6-row blocks (mesh 4x2 of 24^2): the multi-hop exchange each stage
    n, k, dh, nt, stages = 24, 1.0, 0.05, 3, 4
    dt = 0.8 * rkc_bound(eps, k, dh, stages)
    kw = dict(nt=nt, eps=eps, k=k, dt=dt, dh=dh, stepper="rkc", stages=stages)
    t, j = _pair2d(mx, my, n, **kw)
    o = Solver2D(n, n, device=CPU, method="cuda", **kw)
    ut, uj, uo = _run(t, j, o)
    assert np.array_equal(ut, uo)  # per-stage: the single-device program, bitwise
    assert np.abs(ut - uj).max() <= 1e-12
    if eps == 2:  # eps 7 at dh 0.05 is too coarse a horizon for the 1e-6 contract
        assert t.error_l2 / n**2 <= L2_THRESHOLD


@pytest.mark.parametrize("eps", [2, 7])
def test_perstage_rkc_fused_bitwise_collective(eps):
    n, k, dh, nt, stages = 24, 1.0, 0.05, 3, 4
    kw = dict(nt=nt, eps=eps, k=k, dt=0.8 * rkc_bound(eps, k, dh, stages), dh=dh,
              stepper="rkc", stages=stages)
    f, j = _pair2d(4, 2, n, comm="fused", **kw)
    c, _ = _pair2d(4, 2, n, **kw)
    uf, uc, uj = _run(f, c, j)
    assert np.array_equal(uf, uc)
    assert np.abs(uf - uj).max() <= 1e-12


@pytest.mark.parametrize("ksteps", [2, 3])
def test_stage_batches_match_jax_and_the_perstage_form(ksteps):
    n, eps, k, dh, nt, stages = 24, 2, 1.0, 0.05, 3, 6
    kw = dict(nt=nt, eps=eps, k=k, dt=0.8 * rkc_bound(eps, k, dh, stages), dh=dh,
              stepper="rkc", stages=stages)
    t, j = _pair2d(4, 2, n, superstep=ksteps, **kw)
    per, _ = _pair2d(4, 2, n, **kw)
    o = Solver2D(n, n, device=CPU, method="cuda", **kw)
    ut, uj, up, uo = _run(t, j, per, o)
    assert np.abs(ut - uj).max() <= 1e-12
    assert np.abs(ut - up).max() <= 1e-12
    assert np.abs(ut - uo).max() <= 1e-12
    # production (no source): the same schedule from a seeded state
    u0 = np.random.default_rng(0).normal(size=(n, n))
    t2, j2 = _pair2d(4, 2, n, superstep=ksteps, **kw)
    o2 = Solver2D(n, n, device=CPU, method="cuda", **kw)
    ut2, uj2, uo2 = _run(t2, j2, o2, u0=u0)
    assert np.abs(ut2 - uj2).max() <= 1e-12
    assert np.abs(ut2 - uo2).max() <= 1e-12


def test_stage_batch_multihop():
    # a batch of 3 at eps 3 pads 9 cells over 6-row blocks: two hops a carry
    n, eps, k, dh, nt, stages = 24, 3, 1.0, 0.05, 2, 5
    kw = dict(nt=nt, eps=eps, k=k, dt=0.8 * rkc_bound(eps, k, dh, stages), dh=dh,
              stepper="rkc", stages=stages)
    t, j = _pair2d(4, 2, n, superstep=3, **kw)
    ut, uj = _run(t, j)
    assert np.abs(ut - uj).max() <= 1e-12


def test_distributed_rkc_manufactured_9x_euler_dt():
    n, eps, k, dh, stages = 24, 2, 1.0, 0.01, 8
    dt = 9.0 * stable_dt_op(NonlocalOp2D(eps, k, 1.0, dh))
    assert dt <= rkc_bound(eps, k, dh, stages)
    t = td2.Solver2DDistributed(6, 12, 4, 2, 5, eps, k=k, dt=dt, dh=dh, method="cuda",
                                mesh=make_mesh(4, 2, DEVS), dtype=F64, stepper="rkc",
                                stages=stages)
    _run(t)
    assert t.error_l2 / n**2 <= L2_THRESHOLD


@pytest.mark.parametrize("K", [1, 2])
def test_distributed_rkc_3d(K):
    n, eps, k, dh, nt, stages = 8, 2, 1.0, 0.0625, 3, 4
    dt = 0.8 * stable_dt_op(NonlocalOp3D(eps, k, 1.0, dh), "rkc", stages)
    kw = dict(nt=nt, eps=eps, k=k, dt=dt, dh=dh, stepper="rkc", stages=stages, superstep=K)
    t = td3.Solver3DDistributed(n, n, n, mesh=make_mesh_3d(2, 2, 2, DEVS), method="cuda",
                                dtype=F64, **kw)
    j = jd3.Solver3DDistributed(n, n, n, method="sat",
                                mesh=jmesh.make_mesh_3d(2, 2, 2, devices=jax.devices()), **kw)
    kw.pop("superstep")
    o = Solver3D(n, n, n, device=CPU, method="cuda", **kw)
    ut, uj, uo = _run(t, j, o)
    assert np.abs(ut - uj).max() <= 1e-12
    if K == 1:
        assert np.array_equal(ut, uo)
    assert np.abs(ut - uo).max() <= 1e-12


def test_fused_3d_rkc_bitwise_collective():
    n, eps, dh, stages = 8, 2, 0.0625, 4
    dt = 0.8 * stable_dt_op(NonlocalOp3D(eps, 1.0, 1.0, dh), "rkc", stages)
    kw = dict(nt=2, eps=eps, k=1.0, dt=dt, dh=dh, stepper="rkc", stages=stages,
              method="cuda", dtype=F64)
    f = td3.Solver3DDistributed(n, n, n, mesh=make_mesh_3d(2, 2, 2, DEVS), comm="fused", **kw)
    c = td3.Solver3DDistributed(n, n, n, mesh=make_mesh_3d(2, 2, 2, DEVS), **kw)
    uf, uc = _run(f, c)
    assert np.array_equal(uf, uc)


# -- the step builders against the JAX ones ------------------------------------------------

def test_rkc_coeffs_and_validation_match_jax():
    from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JOp

    for stages in (2, 4, 8):
        top = NonlocalOp2D(2, 1.0, 0.8 * rkc_bound(2, 1.0, 0.05, stages), 0.05)
        jop = JOp(2, 1.0, top.dt, 0.05)
        assert tsh.validate_dist_stepper(top, "rkc", stages) == jsh.validate_dist_stepper(
            jop, "rkc", stages)


# -- refusals: the JAX words -------------------------------------------------------------

def test_distributed_stepper_refusals():
    kw = dict(nx=6, ny=12, npx=4, npy=2, nt=3, eps=2, k=1.0, dh=0.05,
              mesh=make_mesh(4, 2, DEVS), method="conv")
    bound = rkc_bound(2, 1.0, 0.05, 4)
    with pytest.raises(ValueError, match="RKC stability"):
        td2.Solver2DDistributed(dt=bound * 1.01, stepper="rkc", stages=4, **kw)
    td2.Solver2DDistributed(dt=bound * 0.99, stepper="rkc", stages=4, **kw)
    with pytest.raises(ValueError, match="whole-domain"):
        td2.Solver2DDistributed(dt=1e-5, stepper="expo", **kw)
    with pytest.raises(ValueError, match="stages >= 2"):
        td2.Solver2DDistributed(dt=1e-5, stepper="rkc", stages=1, **kw)
    with pytest.raises(ValueError, match="unknown stepper"):
        td2.Solver2DDistributed(dt=1e-5, stepper="rk4", **kw)
    # the fused transport fuses one exchange into each apply: no stage batches
    # (the JAX solver's require_fused with ksteps, and the port's)
    with pytest.raises(ValueError, match="superstep"):
        td2.Solver2DDistributed(dt=bound * 0.5, stepper="rkc", stages=4, comm="fused",
                                superstep=2, **{**kw, "method": "cuda"})
    with pytest.raises(ValueError, match="superstep"):
        jd2.Solver2DDistributed(dt=bound * 0.5, stepper="rkc", stages=4, comm="fused",
                                superstep=2, **{**kw, "method": "pallas",
                                                "mesh": jmesh.make_mesh(4, 2)})


# -- the exchange counters ---------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 4])
def test_halo_obs_rounds_match_jax(K):
    kw = dict(nt=3, eps=2, k=1.0, dt=1e-5, dh=0.05, stepper="rkc", stages=6, superstep=K)
    t, j = _pair2d(4, 2, 24, **kw)
    before = [TREG.counter(n).value for n in ("/halo/exchanges", "/halo/bytes")]
    ours, theirs = t._halo_obs(3), j._halo_obs(3)
    assert ours == theirs
    assert ours["rounds"] == 3 * -(-6 // K)
    after = [TREG.counter(n).value for n in ("/halo/exchanges", "/halo/bytes")]
    assert after[0] - before[0] == ours["rounds"] * ours["messages_per_round"]


# -- checkpoints across the packages ------------------------------------------------------

def test_jax_rkc_checkpoint_resumes_in_the_port_and_the_reverse(tmp_path):
    n, eps, k, dh, stages = 24, 2, 1.0, 0.05, 4
    dt = 0.8 * rkc_bound(eps, k, dh, stages)
    kw = dict(eps=eps, k=k, dt=dt, dh=dh, stepper="rkc", stages=stages)
    full = Solver2D(n, n, 6, device=CPU, method="cuda", **kw)
    uf, = _run(full)
    # JAX writes at step 3 (ncheckpoint 3, stopped there), the port resumes to 6
    ck = tmp_path / "jax.npz"
    j = jd2.Solver2DDistributed(6, 12, 4, 2, 3, mesh=jmesh.make_mesh(4, 2), method="conv",
                                checkpoint_path=str(ck), ncheckpoint=3, **kw)
    _run(j)
    u, t, params = load_state(str(ck))
    assert t == 3
    s = convert.solver2d_distributed_from_jax_state(params, u, t, (4, 2), device="cpu",
                                                    dtype=F64, nt=6, method="cuda",
                                                    stepper="rkc", stages=stages)
    assert np.abs(s.do_work() - uf).max() <= 1e-12
    # the port writes at step 3, the JAX distributed solver resumes to 6
    ck2 = tmp_path / "port.npz"
    p = td2.Solver2DDistributed(6, 12, 4, 2, 3, mesh=make_mesh(4, 2, DEVS), method="cuda",
                                dtype=F64, checkpoint_path=str(ck2), ncheckpoint=3, **kw)
    _run(p)
    r = jd2.Solver2DDistributed(6, 12, 4, 2, 6, mesh=jmesh.make_mesh(4, 2), method="conv",
                                **kw)
    r.test_init()
    r.resume(str(ck2))
    assert r.t0 == 3
    assert np.abs(np.asarray(r.do_work()) - uf).max() <= 1e-12


# -- the distributed CLIs' stepper surface (JAX tests/test_distributed_rkc.py:608-658) ----

def _cli(main, argv, capsys, monkeypatch, stdin=""):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = main(["--platform", "cpu", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_distributed_rkc_row_passes(capsys, monkeypatch):
    rc, out, err = _cli(tcli.main, ["--test_batch", "--stepper", "rkc",
                                    "--superstep-stages", "4", "--devices", "4"],
                        capsys, monkeypatch, "1\n12 12 2 2 4 2 1.0 0.005 0.05\n")
    assert rc == 0 and out.splitlines()[-1] == "Tests Passed", out + err


@pytest.mark.parametrize("extra", [[], ["--superstep", "2"], ["--comm", "fused",
                                                              "--method", "cuda"]])
def test_cli_distributed_rkc_matches_the_jax_cli(capsys, monkeypatch, extra):
    from nonlocalheatequation_tpu.cli import solve2d_distributed as jcli

    argv = ["--nx", "6", "--ny", "6", "--npx", "2", "--npy", "2", "--nt", "3", "--eps", "2",
            "--dt", "0.002", "--stepper", "rkc", "--superstep-stages", "4", "--cmp",
            "false", "--no-header"]
    rc, out, err = _cli(tcli.main, argv + ["--devices", "4"] + extra, capsys, monkeypatch)
    assert rc == 0, err
    jextra = [{"cuda": "pallas"}.get(a, a) for a in extra]
    rc_j = jcli.main(argv + ["--platform", "cpu", "--devices", "4"] + jextra)
    jout = capsys.readouterr()
    assert rc_j == 0
    def l2(text):
        return float(next(r for r in text.splitlines() if r.startswith("l2:")).split()[1])

    assert l2(out) == pytest.approx(l2(jout.out), rel=1e-9)
    assert "rkc[s=4]" in err and "bound in force" in err


def test_cli_distributed_stepper_refusals(capsys, monkeypatch):
    # rc 2: past the rkc bound, the bound in force printed
    rc, _, err = _cli(tcli.main, ["--test", "true", "--nx", "12", "--ny", "12", "--nt", "3",
                                  "--eps", "2", "--dt", "0.05", "--stepper", "rkc",
                                  "--superstep-stages", "4"], capsys, monkeypatch)
    assert rc == 2
    assert "rkc[s=4] stability bound" in err and "bound in force" in err
    for argv, words in (
            (["--stepper", "expo"], "requires --method fft"),
            (["--nbalance", "5", "--stepper", "rkc"], "elastic executor"),
            (["--nbalance", "5", "--method", "fft"], "elastic executor"),
            (["--method", "fft", "--comm", "fused"], "pencil"),
            (["--method", "fft", "--superstep", "2"], "no superstep form")):
        rc, _, err = _cli(tcli.main, ["--test", "true", "--devices", "4", *argv], capsys,
                          monkeypatch)
        assert rc == 1 and words in err, (argv, err)


def test_cli_solve3d_distributed_rkc_and_expo(capsys, monkeypatch):
    rc, out, err = _cli(tcli3.main, ["--test", "--distributed", "--nx", "8", "--ny", "8",
                                     "--nz", "8", "--nt", "3", "--eps", "2", "--dt", "0.002",
                                     "--stepper", "rkc", "--superstep-stages", "4",
                                     "--no-header"], capsys, monkeypatch)
    assert rc == 0, err
    assert "rkc[s=4]" in err
    l2 = next(r for r in out.splitlines() if r.startswith("l2:"))
    assert float(l2.split()[1]) / 512 <= L2_THRESHOLD
    rc, out, err = _cli(tcli3.main, ["--test", "--distributed", "--method", "fft",
                                     "--stepper", "expo", "--nx", "8", "--ny", "8", "--nz",
                                     "8", "--nt", "3", "--eps", "2", "--cmp", "0"],
                        capsys, monkeypatch)
    assert rc == 0, err
    rc, _, err = _cli(tcli3.main, ["--test", "--distributed", "--method", "fft", "--comm",
                                   "fused"], capsys, monkeypatch)
    assert rc == 1 and "pencil" in err


def test_single_device_rkc_reference_is_the_jax_solve():
    # the bitwise anchor above is the port's Solver2D; it holds the JAX one
    n, eps, k, dh, stages = 24, 2, 1.0, 0.05, 4
    kw = dict(eps=eps, k=k, dt=0.8 * rkc_bound(eps, k, dh, stages), dh=dh, stepper="rkc",
              stages=stages)
    o = Solver2D(n, n, 3, device=CPU, method="cuda", **kw)
    j = JSolver2D(n, n, 3, backend="jit", method="conv", **kw)
    uo, uj = _run(o, j)
    assert np.abs(uo - uj).max() <= 1e-12
