"""The port's distributed solvers (parallel/distributed2d.py,
distributed3d.py), the distributed CLI and the 3D CLI's --distributed,
against the JAX package's on the CPU.

The JAX solvers run on the suite's 8 virtual CPU devices (tests/conftest.py),
``method="pallas"`` in Pallas interpret mode, as tests/test_distributed.py,
test_distributed3d.py and test_halo_fused.py run them; the port's meshes
hold the same shapes of virtual CPU devices (parallel/mesh.py).  The same
seeded NumPy input goes to both packages.

Tolerances: the port's ``comm="fused"`` is bitwise its ``comm="collective"``
(the split sum is bitwise the one-pass sum); both solvers, every comm and
superstep, hold the JAX solvers and the port's single-device solvers to
1e-12 (float64; the sums run in other orders); the manufactured contract
error_l2/#points <= 1e-6 (``BF16_L2_BUDGET`` on the bf16 tier).
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
from nonlocalheatequation_torch.obs import trace as tobs_trace
from nonlocalheatequation_torch.obs.metrics import REGISTRY as TREG
from nonlocalheatequation_torch.ops.constants import BF16_L2_BUDGET
from nonlocalheatequation_torch.parallel import distributed2d as td2
from nonlocalheatequation_torch.parallel import distributed3d as td3
from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d
from nonlocalheatequation_torch.utils.partition_map import PartitionMap, write_partition_map
from nonlocalheatequation_torch.utils.timing import print_time_results_distributed
from nonlocalheatequation_tpu.cli import solve2d_distributed as jcli
from nonlocalheatequation_tpu.obs import trace as jobs_trace
from nonlocalheatequation_tpu.obs.metrics import REGISTRY as JREG
from nonlocalheatequation_tpu.ops import pallas_halo as jh
from nonlocalheatequation_tpu.parallel import distributed2d as jd2
from nonlocalheatequation_tpu.parallel import distributed3d as jd3
from nonlocalheatequation_tpu.parallel import mesh as jmesh
from nonlocalheatequation_tpu.utils import timing as jtiming
from tests.cases import CASES_2D_DISTRIBUTED, L2_THRESHOLD

torch.set_num_threads(1)
CPU = torch.device("cpu")
DEVS = device_list("cpu", 8)


def _mesh(mx, my):
    return make_mesh(mx, my, DEVS)


def _mesh3(mx, my, mz):
    return make_mesh_3d(mx, my, mz, DEVS)


def _jmesh3(mx, my, mz):
    return jmesh.make_mesh_3d(mx, my, mz, devices=jax.devices()[:mx * my * mz])


def _run(*solvers, u0=None):
    for s in solvers:
        s.test_init() if u0 is None else s.input_init(u0)
    return [np.asarray(s.do_work(), np.float64) for s in solvers]


def _batch(rows) -> str:
    return f"{len(rows)}\n" + "".join(" ".join(str(v) for v in r) + "\n" for r in rows)


# -- 2D: fused bitwise collective, both against the JAX solvers and Solver2D -------------

@pytest.mark.parametrize("mx,my", [(2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("eps", [1, 2])
def test_fused_bitwise_collective_and_jax_2d(mx, my, eps):
    kw = dict(nt=3, eps=eps, k=1.0, dt=1e-4, dh=0.02)
    f = td2.Solver2DDistributed(8, 8, mx, my, mesh=_mesh(mx, my), method="cuda", comm="fused",
                                **kw)
    c = td2.Solver2DDistributed(8, 8, mx, my, mesh=_mesh(mx, my), method="cuda", **kw)
    j = jd2.Solver2DDistributed(8, 8, mx, my, mesh=jmesh.make_mesh(mx, my), method="pallas",
                                comm="fused", **kw)
    o = Solver2D(8 * mx, 8 * my, device=CPU, method="cuda", **kw)
    uf, uc, uj, uo = _run(f, c, j, o)
    assert np.array_equal(uf, uc)
    assert np.abs(uf - uj).max() < 1e-12
    assert np.abs(uf - uo).max() < 1e-12
    assert f.error_l2 / (64 * mx * my) <= L2_THRESHOLD
    assert f.u.dtype == np.float64 and f.mesh.size == mx * my


@pytest.mark.parametrize("eps", [9, 17])
def test_fused_multihop_2d(eps):
    # block edge 8 < eps: the bands cross ceil(eps/8) blocks
    kw = dict(nt=2, eps=eps, k=1.0, dt=1e-4, dh=0.02)
    f = td2.Solver2DDistributed(8, 8, 4, 2, mesh=_mesh(4, 2), method="cuda", comm="fused", **kw)
    c = td2.Solver2DDistributed(8, 8, 4, 2, mesh=_mesh(4, 2), method="cuda", **kw)
    j = jd2.Solver2DDistributed(8, 8, 4, 2, mesh=jmesh.make_mesh(4, 2), method="conv", **kw)
    uf, uc, uj = _run(f, c, j)
    assert np.array_equal(uf, uc)
    assert np.abs(uf - uj).max() < 1e-12


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("init", ["test", "input"])
def test_superstep_matches_jax_2d(K, init):
    # nt=7 is not a multiple of K: the remainder runs a shallower superstep
    kw = dict(nt=7, eps=3, k=0.2, dt=0.0005, dh=0.02, superstep=K)
    t = td2.Solver2DDistributed(10, 10, 4, 2, mesh=_mesh(4, 2), **kw)
    j = jd2.Solver2DDistributed(10, 10, 4, 2, mesh=jmesh.make_mesh(4, 2), method="conv", **kw)
    per_step = td2.Solver2DDistributed(10, 10, 4, 2, mesh=_mesh(4, 2),
                                       **{**kw, "superstep": 1})
    u0 = None if init == "test" else np.random.default_rng(3).normal(size=(40, 20))
    ut, uj, up = _run(t, j, per_step, u0=u0)
    assert np.abs(ut - uj).max() < 1e-12
    assert np.abs(ut - up).max() < 1e-12
    assert t.ksteps == K


def test_superstep_multihop_matches_the_single_device_solve():
    # K*eps = 12 over 5-row blocks: three hops inside the superstep exchange
    t = td2.Solver2DDistributed(20, 20, 1, 1, nt=12, eps=4, k=0.2, dt=0.0005, dh=0.02,
                                mesh=_mesh(4, 2), superstep=3, method="cuda")
    o = Solver2D(20, 20, 12, 4, k=0.2, dt=0.0005, dh=0.02, device=CPU, method="cuda")
    ut, uo = _run(t, o)
    assert np.abs(ut - uo).max() < 1e-12
    assert t.error_l2 / 400 <= L2_THRESHOLD


def test_fused_production_path_2d():
    u0 = np.random.default_rng(0).normal(size=(40, 20))
    kw = dict(nt=4, eps=3, k=1.0, dt=1e-4, dh=0.02, method="cuda", mesh=_mesh(4, 2))
    f = td2.Solver2DDistributed(10, 10, 4, 2, comm="fused", **kw)
    c = td2.Solver2DDistributed(10, 10, 4, 2, **kw)
    j = jd2.Solver2DDistributed(10, 10, 4, 2, nt=4, eps=3, k=1.0, dt=1e-4, dh=0.02,
                                mesh=jmesh.make_mesh(4, 2), method="conv")
    uf, uc, uj = _run(f, c, j, u0=u0)
    assert np.array_equal(uf, uc)
    assert np.abs(uf - uj).max() < 1e-12


def test_fused_bf16_tier_bitwise_and_within_its_budget():
    n, eps, nt = 48, 4, 40
    probe = td2.NonlocalOp2D(eps, 1.0, 1.0, 1.0 / n)
    dt = 0.8 / (probe.c * probe.dh ** 2 * probe.wsum)  # a stable dt, as the tier's contract
    kw = dict(nt=nt, eps=eps, k=1.0, dt=dt, dh=1.0 / n, method="cuda", precision="bf16",
              dtype=torch.float32, mesh=_mesh(2, 2))
    f = td2.Solver2DDistributed(n // 2, n // 2, 2, 2, comm="fused", **kw)
    c = td2.Solver2DDistributed(n // 2, n // 2, 2, 2, **kw)
    uf, uc = _run(f, c)
    assert np.array_equal(uf, uc)
    assert f.error_l2 / n ** 2 <= BF16_L2_BUDGET


# -- 3D ---------------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1, 2, 5])
def test_fused_bitwise_collective_and_jax_3d(eps):
    # 2x2x2 mesh of 4^3 blocks: eps=2 is degenerate (one pass), eps=5 multi-hop
    kw = dict(nt=2, eps=eps, k=1.0, dt=1e-4, dh=0.05)
    f = td3.Solver3DDistributed(8, 8, 8, mesh=_mesh3(2, 2, 2), method="cuda", comm="fused",
                                **kw)
    c = td3.Solver3DDistributed(8, 8, 8, mesh=_mesh3(2, 2, 2), method="cuda", **kw)
    j = jd3.Solver3DDistributed(8, 8, 8, mesh=_jmesh3(2, 2, 2), method="pallas", comm="fused",
                                **kw)
    o = Solver3D(8, 8, 8, device=CPU, method="cuda", **kw)
    uf, uc, uj, uo = _run(f, c, j, o)
    assert np.array_equal(uf, uc)
    assert np.abs(uf - uj).max() < 1e-12
    assert np.abs(uf - uo).max() < 1e-12


@pytest.mark.parametrize("K", [1, 2, 3])
def test_superstep_matches_jax_3d(K):
    kw = dict(nt=7, eps=2, k=0.5, dt=0.0005, dh=0.05, superstep=K)
    t = td3.Solver3DDistributed(12, 12, 12, mesh=_mesh3(2, 2, 2), **kw)
    j = jd3.Solver3DDistributed(12, 12, 12, mesh=_jmesh3(2, 2, 2), method="sat", **kw)
    o = Solver3D(12, 12, 12, 7, 2, k=0.5, dt=0.0005, dh=0.05, device=CPU, method="sat")
    ut, uj, uo = _run(t, j, o)
    assert np.abs(ut - uj).max() < 1e-12
    assert np.abs(ut - uo).max() < 1e-12
    assert t.error_l2 / 12 ** 3 <= L2_THRESHOLD


def test_3d_multihop_free_decay_matches_jax():
    # 12^3 on a (4, 2, 1) mesh: x blocks of 3 < eps=4
    u0 = np.random.default_rng(5).normal(size=(12, 12, 12))
    kw = dict(nt=4, eps=4, k=0.2, dt=0.0005, dh=0.05)
    t = td3.Solver3DDistributed(12, 12, 12, mesh=_mesh3(4, 2, 1), **kw)
    j = jd3.Solver3DDistributed(12, 12, 12, mesh=_jmesh3(4, 2, 1), **kw)
    ut, uj = _run(t, j, u0=u0)
    assert np.abs(ut - uj).max() < 1e-12


# -- meshes ------------------------------------------------------------------------------

def test_mesh_choice_equals_jax():
    for NX, NY, n in [(50, 50, 8), (20, 20, 8), (40, 20, 8), (7, 9, 8), (24, 18, 6), (5, 5, 4),
                      (16, 16, 1), (4096, 4096, 4)]:
        assert td2.choose_mesh_shape(NX, NY, n) == jd2.choose_mesh_shape(NX, NY, n)
    for NX, NY, NZ, n in [(16, 16, 16, 8), (12, 12, 12, 8), (12, 6, 9, 8), (7, 7, 7, 8),
                          (256, 256, 256, 8), (8, 4, 2, 4)]:
        assert td3.choose_mesh_shape_3d(NX, NY, NZ, n) == jd3.choose_mesh_shape_3d(
            NX, NY, NZ, n)
    m = td2.choose_mesh_for_grid(50, 50, DEVS)
    assert tuple(m.shape.values()) == tuple(jd2.choose_mesh_for_grid(50, 50).shape.values())
    m3 = td3.choose_mesh_for_grid_3d(16, 16, 16, DEVS)
    assert m3.shape == {"x": 2, "y": 2, "z": 2}


def test_default_mesh_is_the_card_or_the_requested_cpu():
    s = td2.Solver2DDistributed(10, 10, 2, 2, nt=1, eps=2, device="cpu")
    assert s.mesh.size == 1 and s.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            td2.Solver2DDistributed(10, 10, 2, 2, nt=1, eps=2)
        with pytest.raises(RuntimeError, match="is_available"):
            td3.Solver3DDistributed(8, 8, 8, nt=1, eps=2)


# -- refusals by name -------------------------------------------------------------------

class _Logged(list):
    """A logger recording the steps it was called at."""

    def __call__(self, t, u):
        self.append(t)


#: (kwargs, refusal) — a refusal of None: ported since, the solve runs
REFUSALS_2D = [
    (dict(stepper="expo"), "on the distributed path it requires method='fft'"),
    (dict(method="fft", comm="fused"), "pencil transposes .* comm='fused' is a stencil-halo"),
    (dict(checkpoint_path="x.npz", ncheckpoint=2), None),
    (dict(logger=_Logged()), None),
    (dict(nbalance=10), "cannot rebalance; use parallel.elastic.ElasticSolver2D for nbalance"),
    (dict(resync_every=2, precision="bf16"), "resync_every is not supported on the distributed"),
    (dict(comm="rdma"), "collective' or 'fused"),
    (dict(comm="fused"), "needs method='cuda'"),
    (dict(comm="fused", method="cuda", superstep=2), "superstep"),
]


def _refused_or_runs(make, kw, match, tmp_path, monkeypatch):
    if match is not None:
        with pytest.raises(ValueError, match=match):
            make(**kw)
        return
    # ported since: the solve runs and writes its checkpoint, or logs step 0
    monkeypatch.chdir(tmp_path)
    if "logger" in kw:
        kw["logger"].clear()
    s = make(**kw)
    s.test_init()
    s.do_work()
    if "logger" in kw:
        assert kw["logger"] == [0]
    else:
        assert (tmp_path / kw["checkpoint_path"]).is_file()


@pytest.mark.parametrize("kw,match", REFUSALS_2D)
def test_solver_refusals_2d(kw, match, tmp_path, monkeypatch):
    _refused_or_runs(lambda **kw: td2.Solver2DDistributed(8, 8, 2, 2, nt=2, eps=2,
                                                          mesh=_mesh(2, 2), **kw),
                     kw, match, tmp_path, monkeypatch)


@pytest.mark.parametrize("kw,match", [r for r in REFUSALS_2D
                                      if "nbalance" not in r[0] and "resync_every" not in r[0]])
def test_solver_refusals_3d(kw, match, tmp_path, monkeypatch):
    _refused_or_runs(lambda **kw: td3.Solver3DDistributed(8, 8, 8, nt=2, eps=1,
                                                          mesh=_mesh3(2, 2, 2), **kw),
                     kw, match, tmp_path, monkeypatch)


# -- observability ------------------------------------------------------------------------

def test_halo_counters_and_span_equal_jax():
    nt, eps = 3, 2
    deltas, spans = [], []
    for reg, obs, solver in (
            (TREG, tobs_trace, td2.Solver2DDistributed(8, 8, 2, 2, nt=nt, eps=eps, k=1.0,
                                                       dt=1e-4, dh=0.02, mesh=_mesh(2, 2),
                                                       method="cuda", comm="fused")),
            (JREG, jobs_trace, jd2.Solver2DDistributed(8, 8, 2, 2, nt=nt, eps=eps, k=1.0,
                                                       dt=1e-4, dh=0.02,
                                                       mesh=jmesh.make_mesh(2, 2),
                                                       method="pallas", comm="fused"))):
        solver.test_init()
        before = [reg.counter(n).value for n in ("/halo/exchanges", "/halo/bytes")]
        tracer = obs.Tracer()
        prev = obs.set_tracer(tracer)
        try:
            solver.do_work()
        finally:
            obs.set_tracer(prev)
        deltas.append([reg.counter(n).value - b
                       for n, b in zip(("/halo/exchanges", "/halo/bytes"), before)])
        spans.append([e["args"] for e in tracer.events if e["name"] == "halo.exchange"])
    assert deltas[0] == deltas[1]
    stats = jh.halo_stats((2, 2), (8, 8), eps, "collective", 8)
    assert deltas[0] == [nt * stats["messages"] * 4, nt * stats["bytes"] * 4]
    assert len(spans[0]) == len(spans[1]) == 1
    assert spans[0][0] == spans[1][0]
    assert spans[0][0]["transport"] == "interp" and spans[0][0]["rounds"] == nt


def test_halo_stats_of_the_in_kernel_exchange_equal_the_jax_rdma_stats():
    # a mesh of CUDA cards runs the in-kernel exchange (transport 'peer'); its
    # scheduled traffic is the JAX package's remote-DMA plan (no card needed
    # to read it: construction and _halo_obs touch no device)
    cards = [torch.device("cuda", 0)] * 4
    s = td2.Solver2DDistributed(8, 8, 2, 2, nt=3, eps=2, mesh=make_mesh(2, 2, cards),
                                method="cuda", comm="fused", dtype=torch.float64)
    before = [TREG.counter(n).value for n in ("/halo/exchanges", "/halo/bytes")]
    attrs = s._halo_obs(3)
    stats = jh.halo_stats((2, 2), (8, 8), 2, "fused", 8)
    assert attrs["transport"] == "peer"
    assert attrs["bytes_per_device_round"] == stats["bytes"] == 640
    assert attrs["messages_per_round"] == stats["messages"] * 4
    assert [TREG.counter(n).value - b for n, b in zip(("/halo/exchanges", "/halo/bytes"),
                                                        before)] == [3 * 8 * 4, 3 * 640 * 4]


# -- carrying a JAX solve into the port -------------------------------------------------

@pytest.mark.parametrize("dims", [2, 3])
def test_convert_carries_a_jax_distributed_solve(dims):
    if dims == 2:
        kw = dict(eps=3, k=0.5, dt=0.0005, dh=0.02)
        j = jd2.Solver2DDistributed(8, 8, 2, 2, nt=3, mesh=jmesh.make_mesh(2, 2), **kw)
        full = jd2.Solver2DDistributed(8, 8, 2, 2, nt=6, mesh=jmesh.make_mesh(2, 2), **kw)
        carry, mesh_shape = convert.solver2d_distributed_from_jax_state, (2, 2)
    else:
        kw = dict(eps=2, k=0.5, dt=0.0005, dh=0.05)
        j = jd3.Solver3DDistributed(8, 8, 8, nt=3, mesh=_jmesh3(2, 2, 2), **kw)
        full = jd3.Solver3DDistributed(8, 8, 8, nt=6, mesh=_jmesh3(2, 2, 2), **kw)
        carry, mesh_shape = convert.solver3d_distributed_from_jax_state, (2, 2, 2)
    uj, uf = _run(j, full)
    s = carry(j._ckpt_params(), uj, 3, mesh_shape, device="cpu", dtype=torch.float64, nt=6)
    assert s.t0 == 3 and s.test and s.mesh.size == int(np.prod(mesh_shape))
    assert np.abs(s.do_work() - uf).max() < 1e-12
    assert s.error_l2 == pytest.approx(full.error_l2, rel=1e-6)
    with pytest.raises(ValueError, match="does not divide"):
        carry(j._ckpt_params(), uj, 3, (3,) * dims, device="cpu", dtype=torch.float64)


# -- the distributed CLI ------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--method", "cuda", "--comm", "fused"]])
def test_cli_cases_2d_distributed_pass(monkeypatch, capsys, extra):
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch(CASES_2D_DISTRIBUTED)))
    rc = tcli.main(["--test_batch", "--platform", "cpu", "--devices", "8", *extra])
    out = capsys.readouterr().out
    assert rc == 0 and out.splitlines()[-1] == "Tests Passed", out


def test_cli_single_solve_prints_the_jax_lines(monkeypatch, capsys):
    argv = ["--nx", "6", "--ny", "6", "--npx", "2", "--npy", "2", "--nt", "4", "--eps", "2",
            "--cmp", "true", "--no-header"]
    assert tcli.main(argv + ["--platform", "cpu", "--devices", "4"]) == 0
    ours = capsys.readouterr().out.splitlines()
    s = jd2.Solver2DDistributed(6, 6, 2, 2, 4, 2, dh=0.05, mesh=jmesh.make_mesh(2, 2))
    s.test_init()
    s.do_work()
    s.print_error(True)
    want = capsys.readouterr().out.splitlines()
    # the version banner, then print_error's lines (l2, then 144 "sx: .. sy: .." rows)
    assert ours[1].split()[0] == want[0].split()[0] == "l2:"
    assert float(ours[1].split()[1]) == pytest.approx(float(want[0].split()[1]), rel=1e-9)
    assert [r.split("Actual")[0] for r in ours[2:2 + 144]] == [
        r.split("Actual")[0] for r in want[1:]]
    assert ours[-1].split(",")[0] == "4"  # the localities column of the timing row
    # free decay from stdin
    monkeypatch.setattr(sys, "stdin", io.StringIO(" ".join(["1.0"] * 144)))
    assert tcli.main(argv[:-3] + ["--test", "false", "--platform", "cpu", "--results"]) == 0
    assert "S[0][0] = " in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["--file", "map.txt"], None),
    (["--nbalance", "5"], None),
    (["--test_load_balance"], None),
    (["--checkpoint", "c.npz", "--ncheckpoint", "2"], None),
    (["--resume"], None),
    (["--log"], None),
    (["--profile", "d"], None),
    (["--stepper", "expo"], "requires --method fft"),
    (["--method", "fft", "--comm", "fused"], "pencil transposes; --comm fused is a stencil"),
    (["--comm", "fused"], "needs method='cuda'"),
    (["--comm", "fused", "--method", "cuda", "--superstep", "2"], "superstep"),
    (["--resync", "2", "--precision", "bf16"], "--resync is not supported"),
    (["--superstep-stages", "4"], "--stepper euler takes no stage count"),
])
def test_cli_refusals(capsys, tmp_path, monkeypatch, argv, message):
    import re

    base = ["--platform", "cpu", "--devices", "4", "--nt", "2"]
    if message is not None:
        assert tcli.main(argv + base) == 1
        assert re.search(message, capsys.readouterr().err)
        return
    # ported since: the flag runs a single solve (rc 0) and writes its files
    monkeypatch.chdir(tmp_path)
    if argv[0] in ("--file", "--nbalance", "--test_load_balance"):
        # the elastic executor: the same lines as the JAX CLI's
        write_partition_map("map.txt", PartitionMap(6, 6, 2, 2, 0.05, np.array([[0, 1], [1, 1]])))
        assert tcli.main(base + argv + ["--test_load_balance"]) == 0
        ours = _elastic_lines(capsys.readouterr().out)
        assert jcli.main(argv + ["--test_load_balance", "--devices", "4", "--nt", "2"]) == 0
        assert ours == _elastic_lines(capsys.readouterr().out)
        assert ours[-1].split(",")[0] == "4" and len(ours) > 3
        return
    if argv == ["--resume"]:
        assert tcli.main(["--checkpoint", "c.npz", "--ncheckpoint", "2"] + base) == 0
        argv = ["--checkpoint", "c.npz", "--resume", "--nt", "4"]
    assert tcli.main(base + argv) == 0
    assert "l2: " in capsys.readouterr().out
    written = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())
    if "--log" in argv:
        assert written == ["out_csv/score_2d.csv", "out_csv/simulate_2d.csv",
                           "out_vtk/simulate_0.vtu"]
    elif "--profile" in argv:
        assert len(written) == 1 and written[0].startswith("d/")
    else:
        assert written == ["c.npz"]


def _elastic_lines(out: str) -> list:
    """A single solve's lines from the balance report (or the l2 line) on:
    the measured rates, the verdict on them and the wall time masked, the
    rest as printed."""
    import re

    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith(("Testing load balance", "l2: ")))
    masked = [re.sub(r"(counter value:|Expected busy rate) .*", r"\1 *",
                     re.sub(r"^Load (not )?balanced correctly$", "Load * balanced", line))
              for line in lines[start:]]
    row = masked[-1].split(",")
    return masked[:-1] + [",".join(row[:2] + row[3:])]


def test_cli_default_platform_is_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform runs")
    assert tcli.main(["--nt", "1"]) == 2
    assert "is_available() is false" in capsys.readouterr().err


def test_timing_row_matches_the_jax_package(capsys):
    for header in (True, False):
        print_time_results_distributed(4, 8, 0.0123456789012345, 25, 25, 2, 2, 45,
                                       header=header)
        ours = capsys.readouterr().out
        jtiming.print_time_results_distributed(4, 8, 0.0123456789012345, 25, 25, 2, 2, 45,
                                               header=header)
        assert ours == capsys.readouterr().out


# -- the 3D CLI's --distributed -----------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--comm", "fused", "--method", "cuda"],
                                   ["--superstep", "2"]])
def test_cli3d_distributed_passes(monkeypatch, capsys, extra):
    rows = [(16, 16, 16, 20, 3, 1.0, 0.0005, 0.0625), (6, 6, 6, 10, 8, 1.0, 0.0001, 1.0 / 6)]
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch(rows)))
    assert tcli3.main(["--test_batch", "--platform", "cpu", "--distributed", *extra]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "Tests Passed"


@pytest.mark.parametrize("argv,message", [
    (["--comm", "fused"], "--comm fused requires --distributed"),
    (["--superstep", "2"], "--superstep requires --distributed"),
    (["--distributed", "--resync", "2", "--precision", "bf16"],
     "--resync is not supported with --distributed"),
    (["--distributed", "--backend", "oracle"], "no oracle backend"),
    (["--distributed", "--ensemble", "--test_batch"], "--ensemble runs the serial"),
    (["--distributed", "--comm", "fused"], "needs method='cuda'"),
])
def test_cli3d_distributed_checks(capsys, argv, message):
    assert tcli3.main(argv + ["--platform", "cpu", "--nt", "2"]) == 1
    assert message in capsys.readouterr().err or pytest.fail(capsys.readouterr().err)


def test_cli3d_distributed_single_solve_matches_the_serial_one(capsys):
    argv = ["--platform", "cpu", "--test", "--nx", "8", "--ny", "8", "--nz", "8", "--nt", "3",
            "--eps", "2", "--no-header"]
    assert tcli3.main(argv + ["--distributed"]) == 0
    dist = capsys.readouterr().out.splitlines()
    assert tcli3.main(argv) == 0
    serial = capsys.readouterr().out.splitlines()
    l2 = [float(lines[1].split()[1]) for lines in (dist, serial)]
    assert l2[0] == pytest.approx(l2[1], rel=1e-9)


def test_jax_distributed_module_defaults_run_the_port(capsys):
    # the JAX CLI's defaults (nx=ny=25, npx=npy=2, dh=0.05, --test true) pass
    assert tcli.main(["--platform", "cpu", "--devices", "4", "--nt", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("l2: ") and out[-2].startswith("Localities,")
