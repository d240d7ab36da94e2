"""The port's unstructured point-cloud solve (ops/unstructured.py,
utils/gmsh.py, cli/solve_unstructured.py) against the JAX package's.

On the CPU, at the JAX suite's sizes (clouds of a few hundred to ~2,000
nodes): the gmsh reader gives the same arrays on data/*.msh and on written
ASCII 4.1, 2.2 and binary 4.1 files; the edge builder, ``edge_w``, ``c`` and
``wsum`` are bitwise the JAX operator's; every layout of ``apply`` holds the
JAX oracle to 1e-12 in float64 (the windowed layout through the
``windowed_matvec`` plain version); the auto policy is the JAX package's
with a CUDA device in place of the TPU; the solver matches the JAX ``jit``
solver to 1e-10 and the manufactured 1e-6 contract; the CLI prints what the
JAX CLI prints and refuses what is not ported by name.
"""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch import convert
from nonlocalheatequation_torch.cli import solve_unstructured as tcli
from nonlocalheatequation_torch.ops import unstructured as tun
from nonlocalheatequation_torch.utils import gmsh as tgmsh
from nonlocalheatequation_torch.utils import vtu as tvtu
from nonlocalheatequation_tpu.ops import unstructured as jun
from nonlocalheatequation_tpu.utils import gmsh as jgmsh
from nonlocalheatequation_tpu.utils import vtu as jvtu
from tests.cases import L2_THRESHOLD

torch.set_num_threads(1)

CPU = "cpu"
MESHES = ["10x10", "50x50", "100x100", "200x200"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def _lattice(m, d=2, seed=0, jitter=0.2, shuffle=False):
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    grids = np.meshgrid(*([np.arange(m) * h] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    pts = pts + rng.uniform(-jitter * h, jitter * h, pts.shape)
    if shuffle:
        pts = pts[rng.permutation(len(pts))]
    return pts, h


def _clouds():
    """(name, points, eps, vol): 2D jittered and shuffled, 3D, 1D, a grid
    with exact boundary distances, a hub node and a self-only horizon."""
    out = []
    pts, h = _lattice(36)
    out.append(("2d-jittered", pts, 3.0 * h * (1 + 0.2 * np.sin(7 * pts[:, 0])), h * h))
    pts, h = _lattice(36, seed=1, shuffle=True)
    out.append(("2d-shuffled", pts, 3.0 * h, h * h))
    pts, h = _lattice(11, d=3, seed=2)
    out.append(("3d", pts, 2.5 * h, h ** 3))
    pts, h = _lattice(400, d=1, seed=3)
    out.append(("1d", pts, 4.0 * h, h))
    pts, h = _lattice(20, jitter=0.0)
    out.append(("grid-ties", pts, 3 * h, h * h))  # exact distances on the boundary
    rng = np.random.default_rng(9)
    pts = rng.uniform(size=(200, 2))
    eps = np.full(200, 0.08)
    eps[0] = 2.0  # a hub sees everyone
    out.append(("hub", pts, eps, 1.0 / 200))
    pts = np.stack([np.linspace(0, 1, 40), np.zeros(40)], axis=1)
    out.append(("self-only", pts, 1e-6, 1.0))
    return out


CLOUDS = _clouds()
IDS = [c[0] for c in CLOUDS]


def _pair(points, eps, vol, k=1.0, dt=1e-5):
    return (jun.UnstructuredNonlocalOp(points, eps, k=k, dt=dt, vol=vol),
            tun.UnstructuredNonlocalOp(points, eps, k=k, dt=dt, vol=vol, device=CPU))


# -- gmsh -------------------------------------------------------------------


@pytest.mark.parametrize("name", MESHES)
def test_gmsh_reader_matches_jax_on_the_data_meshes(name):
    a, b = jgmsh.read_msh(f"data/{name}.msh"), tgmsh.read_msh(f"data/{name}.msh")
    for field in ("node_tags", "coords", "quads"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert np.array_equal(a.quad_coords(), b.quad_coords())


@pytest.mark.parametrize("form", ["ascii41", "binary41", "ascii22"])
def test_gmsh_reader_matches_jax_on_written_files(tmp_path, form):
    path = str(tmp_path / f"m_{form}.msh")
    if form == "ascii22":
        pts = np.random.default_rng(4).uniform(size=(37, 2))
        tgmsh.write_point_cloud_msh(path, pts)
        assert np.array_equal(tgmsh.read_msh(path).coords[:, :2], pts)
    else:
        tgmsh.write_structured_msh(path, 7, 5, 0.125, x0=0.5, binary=form == "binary41")
    a, b = jgmsh.read_msh(path), tgmsh.read_msh(path)
    for field in ("node_tags", "coords", "quads"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("time", [None, 0.25])
def test_vtu_writer_is_byte_for_byte_the_jax_writer(tmp_path, time):
    pts = np.random.default_rng(5).uniform(size=(30, 2))
    data = {"Temperature": np.linspace(-1, 1, 30), "k": np.arange(30, dtype=np.float32)}
    a, b = str(tmp_path / "port.vtu"), str(tmp_path / "jax.vtu")
    tvtu.write_point_cloud_vtu(a, pts, data, time=time)
    jvtu.write_point_cloud_vtu(b, pts, data, time=time)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = tvtu.read_vtu_point_data(b), jvtu.read_vtu_point_data(a)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in got)
    with pytest.raises(ValueError, match="points must be"):
        tvtu.write_point_cloud_vtu(a, np.zeros((3, 4)), data)


# -- edges and the operator's arrays -----------------------------------------


@pytest.mark.parametrize("name,points,eps,vol", CLOUDS, ids=IDS)
def test_edges_weights_and_constants_bitwise(name, points, eps, vol):
    tgt, src = tun.build_edges(points, eps)
    jt, js = jun.build_edges(points, eps)
    assert tgt.dtype == np.int32 and np.array_equal(tgt, jt) and np.array_equal(src, js)
    jop, top = _pair(points, eps, vol)
    for field in ("edge_w", "c", "wsum"):
        assert np.array_equal(getattr(top, field), getattr(jop, field)), field
    assert top.kmax == jop.kmax
    jc, jw = jop._ell()
    tc, tw = top._ell()
    assert np.array_equal(jc, tc) and np.array_equal(jw, tw)
    u = np.random.default_rng(1).normal(size=top.n)
    assert np.array_equal(top.apply_np(u), jop.apply_np(u))
    g, lg = top.source_parts()
    jg, jlg = jop.source_parts()
    assert np.array_equal(g, jg) and np.array_equal(lg, jlg)
    assert np.array_equal(top.manufactured_solution(7), jop.manufactured_solution(7))


def test_edges_of_two_far_clusters_bitwise(monkeypatch):
    # 50 + 50 uniform points in the unit cube, the second cluster 1e7 away
    # on each axis: far more cells than a dense lattice can number
    monkeypatch.setattr(tun, "_build_edges_native", lambda points, eps: None)
    monkeypatch.setattr(jun, "_build_edges_native", lambda points, eps: None)
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(50, 3))
    pts = np.concatenate([a, rng.uniform(size=(50, 3)) + 1e7])
    tgt, src = tun.build_edges(pts, 0.3)
    jt, js = jun.build_edges(pts, 0.3)
    assert len(jt) == 432
    assert tgt.dtype == np.int32 and np.array_equal(tgt, jt) and np.array_equal(src, js)


def test_edges_accept_a_weighted_influence():
    pts, h = _lattice(20, seed=6)
    J = lambda r: 1.0 - 0.5 * r  # noqa: E731
    jop = jun.UnstructuredNonlocalOp(pts, 3 * h, k=0.7, dt=1e-5, vol=h * h, influence=J)
    top = tun.UnstructuredNonlocalOp(pts, 3 * h, k=0.7, dt=1e-5, vol=h * h, influence=J,
                                     device=CPU)
    for field in ("edge_w", "c", "wsum"):
        assert np.array_equal(getattr(top, field), getattr(jop, field)), field


# -- apply per layout ----------------------------------------------------------


@pytest.mark.parametrize("layout", ["edges", "ell", "windowed", "offsets"])
@pytest.mark.parametrize("name,points,eps,vol", CLOUDS, ids=IDS)
def test_apply_per_layout_matches_jax_to_1e_12(name, points, eps, vol, layout):
    jop, top = _pair(points, eps, vol)
    u = np.random.default_rng(2).normal(size=top.n)
    got = top.apply(torch.tensor(u), layout=layout).numpy()
    assert _rel(got, jop.apply_np(u)) <= 1e-12
    assert _rel(got, np.asarray(jop.apply(jnp.asarray(u), layout=layout))) <= 1e-12
    got32 = top.apply(torch.tensor(u, dtype=torch.float32), layout=layout)
    assert got32.dtype == torch.float32 and _rel(got32.numpy(), jop.apply_np(u)) <= 1e-5


def test_apply_refuses_an_unknown_layout():
    _, top = _pair(*CLOUDS[0][1:])
    with pytest.raises(ValueError, match="unknown layout"):
        top.apply(torch.zeros(top.n, dtype=torch.float64), layout="dia")


# -- the auto policy -----------------------------------------------------------


def test_choose_layout_on_the_cpu_is_jax_off_the_tpu():
    for _, points, eps, vol in CLOUDS:
        jop, top = _pair(points, eps, vol)
        assert top.choose_layout() == jop.choose_layout()
        assert top.choose_layout() in ("ell", "edges")
    hub = _pair(*CLOUDS[IDS.index("hub")][1:])[1]
    assert hub.choose_layout() == "edges" and hub._ell_arrays is None


def test_choose_layout_for_a_cuda_typed_op(monkeypatch):
    """On a CUDA device the gates open as on the TPU: offsets for a
    quasi-grid in its natural order, windowed for a Morton-sortable
    shuffled cloud, then ELL or edges.  The size floors are lowered on the
    class so small clouds reach the coverage and budget gates."""
    monkeypatch.setattr(tun.UnstructuredNonlocalOp, "_OFFSETS_MIN_N", 256)
    monkeypatch.setattr(tun.UnstructuredNonlocalOp, "_WINDOWED_MIN_N", 256)
    cuda = torch.device("cuda")
    pts, h = _lattice(48, jitter=0.0)
    grid = tun.UnstructuredNonlocalOp(pts, 3 * h, k=1.0, dt=1e-6, vol=h * h, device=CPU)
    shuffled = tun.UnstructuredNonlocalOp(*CLOUDS[IDS.index("2d-shuffled")][1:3], k=1.0,
                                          dt=1e-6, device=CPU)
    hub = tun.UnstructuredNonlocalOp(*CLOUDS[IDS.index("hub")][1:3], k=1.0, dt=1e-6,
                                     device=CPU)
    for op in (grid, shuffled, hub):
        assert op.choose_layout() in ("ell", "edges")
        op.device = cuda
    assert grid.choose_layout() == "offsets"
    assert shuffled.choose_layout() == "windowed"
    assert shuffled._windowed_search is not None
    plan = shuffled.windowed_plan()  # reuses the gate's search
    assert shuffled.windowed_plan() is plan and plan.coverage >= 0.9
    assert hub.choose_layout() == "edges"
    # the budget gate: strips above the budget are refused
    monkeypatch.setattr(tun.UnstructuredNonlocalOp, "_WINDOWED_BUDGET_BYTES", 1024)
    shuffled._windowed_stats = None
    assert shuffled.choose_layout() == "ell"
    # the size floors
    monkeypatch.setattr(tun.UnstructuredNonlocalOp, "_OFFSETS_MIN_N", 10 ** 6)
    assert grid.choose_layout() in ("ell", "edges")


# -- the solver ----------------------------------------------------------------


def _solver_clouds():
    pts, h = _lattice(20, jitter=0.0)
    yield "2d-uniform", pts, 3 * h, h * h, 1.0, 20
    pts, h = _lattice(20, jitter=0.0)
    yield "2d-variable", pts, (2.0 + pts[:, 0] * 2.0) * h, h * h, 1.0, 20
    pts, h = _lattice(18, seed=1)
    yield "2d-jittered", pts, 3.2 * h, h * h, 0.5, 15
    pts, h = _lattice(8, d=3, seed=2, jitter=0.0)
    yield "3d", pts, 2.2 * h, h ** 3, 1.0, 10
    pts, h = _lattice(100, d=1, seed=3, jitter=0.0)
    yield "1d", pts, 4.0 * h, h, 1.0, 20


SOLVER_CLOUDS = list(_solver_clouds())


@pytest.mark.parametrize("layout", ["auto", "edges", "ell", "windowed", "offsets"])
@pytest.mark.parametrize("name,points,eps,vol,k,nt", SOLVER_CLOUDS,
                         ids=[c[0] for c in SOLVER_CLOUDS])
def test_solver_matches_jax_and_holds_the_contract(name, points, eps, vol, k, nt, layout):
    jop = jun.UnstructuredNonlocalOp(points, eps, k=k, dt=1e-4, vol=vol)
    top = tun.UnstructuredNonlocalOp(points, eps, k=k, dt=1e-4, vol=vol, device=CPU)
    js = jun.UnstructuredSolver(jop, nt=nt, backend="jit", layout=layout)
    js.test_init()
    js.do_work()
    ts = tun.UnstructuredSolver(top, nt=nt, layout=layout)
    ts.test_init()
    ts.do_work()
    assert ts.u.dtype == np.float64
    assert _rel(ts.u, js.u) <= 1e-10
    assert ts.error_l2 / top.n <= L2_THRESHOLD
    assert abs(ts.error_l2 - js.error_l2) <= 1e-10 * max(js.error_l2, 1e-30)
    if layout == "auto":
        oracle = tun.UnstructuredSolver(top, nt=nt, backend="oracle")
        oracle.test_init()
        oracle.do_work()
        jo = jun.UnstructuredSolver(jop, nt=nt, backend="oracle")
        jo.test_init()
        jo.do_work()
        assert np.array_equal(oracle.u, jo.u)
        assert _rel(ts.u, oracle.u) <= 1e-10


def test_solver_input_init_free_decay_and_float32():
    pts, h = _lattice(16, seed=5)
    jop = jun.UnstructuredNonlocalOp(pts, 3 * h, k=1.0, dt=1e-4, vol=h * h)
    top = tun.UnstructuredNonlocalOp(pts, 3 * h, k=1.0, dt=1e-4, vol=h * h, device=CPU)
    u0 = np.random.default_rng(0).normal(size=top.n)
    js = jun.UnstructuredSolver(jop, nt=12, layout="windowed")
    js.input_init(u0)
    js.do_work()
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        ts = tun.UnstructuredSolver(top, nt=12, layout="windowed", dtype=dtype)
        ts.input_init(u0)
        ts.do_work()
        assert _rel(ts.u, js.u) <= tol
        assert np.abs(ts.u).max() <= np.abs(u0).max()
    assert ts.u.dtype == np.float32 and not ts.test


def test_solver_refuses_what_is_not_ported_by_name(tmp_path):
    _, top = _pair(*CLOUDS[0][1:])
    # the superstep needs the sharded offsets operator (ported since, with its
    # refusal in the JAX words; tests/test_torch_unstructured_sharded.py)
    with pytest.raises(ValueError, match="on a ShardedUnstructuredOp \\(offsets layout\\)"):
        tun.UnstructuredSolver(top, nt=4, superstep=2)
    # checkpointing is ported since (tests/test_torch_checkpoint.py): it runs
    s = tun.UnstructuredSolver(top, nt=4, checkpoint_path=str(tmp_path / "x.npz"),
                               ncheckpoint=2)
    s.test_init()
    s.do_work()
    assert (tmp_path / "x.npz").is_file()
    with pytest.raises(ValueError, match="unknown backend"):
        tun.UnstructuredSolver(top, nt=4, backend="jit")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tun.UnstructuredNonlocalOp(CLOUDS[0][1], CLOUDS[0][2], k=1.0, dt=1e-5)


def test_solver_from_jax_state_resumes_to_1e_10():
    pts, h = _lattice(16, seed=8)
    jop = jun.UnstructuredNonlocalOp(pts, 3 * h, k=1.0, dt=1e-4, vol=h * h)
    first = jun.UnstructuredSolver(jop, nt=6, layout="edges")
    first.test_init()
    first.do_work()
    full = jun.UnstructuredSolver(jop, nt=14, layout="edges")
    full.test_init()
    full.do_work()
    s = convert.unstructured_solver_from_jax_state(jop, first.u, 6, device=CPU, test=True,
                                                   nt=14, layout="edges")
    s.do_work()
    assert _rel(s.u, full.u) <= 1e-10
    assert abs(s.error_l2 - full.error_l2) <= 1e-10 * full.error_l2
    op = convert.unstructured_op_from_jax(jop, device=CPU)
    assert np.array_equal(op.c, jop.c) and np.array_equal(op.src, jop.src)
    jop_c = jun.UnstructuredNonlocalOp(pts, 3 * h, k=1.0, dt=1e-4, vol=h * h, c=2.0)
    with pytest.raises(ValueError, match="c differs"):
        convert.unstructured_op_from_jax(jop_c, device=CPU)
    with pytest.raises(ValueError, match="state shape"):
        convert.unstructured_solver_from_jax_state(jop, np.zeros(3), 0, device=CPU)


# -- the CLI -------------------------------------------------------------------


def _run_cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tcli.main(argv)
    return rc, out.getvalue()


def _jax_expected(name, layout, nt=30, eps_h=3.0):
    """What the JAX CLI computes for this mesh (its spacing, eps, dt and
    solve), without its process start-up."""
    coords = jgmsh.read_msh(f"data/{name}.msh").coords
    pts = coords[:, [d for d in range(3) if np.ptp(coords[:, d]) > 0]]
    n = len(pts)
    sample = pts[np.random.default_rng(0).permutation(n)[: min(n, 512)]]
    best = np.full(len(sample), np.inf)
    for lo in range(0, n, 4096):
        d2 = ((sample[:, None, :] - pts[None, lo:lo + 4096, :]) ** 2).sum(-1)
        d2[d2 == 0] = np.inf
        best = np.minimum(best, d2.min(axis=1))
    dh = float(np.sqrt(best).mean())
    op = jun.UnstructuredNonlocalOp(pts, eps_h * dh, k=1.0, dt=1.0, vol=dh ** 2)
    op.dt = 0.8 / float(np.max(op.c * op.wsum))
    s = jun.UnstructuredSolver(op, nt=nt, layout=layout)
    s.test_init()
    s.do_work()
    return op, s


@pytest.mark.parametrize("name", ["10x10", "50x50"])
@pytest.mark.parametrize("layout", ["auto", "windowed"])
def test_cli_matches_the_jax_solve(name, layout, tmp_path):
    vtu = str(tmp_path / "out.vtu")
    rc, out = _run_cli(["--mesh", f"data/{name}.msh", "--test", "--platform", "cpu",
                        "--layout", layout, "--vtu", vtu])
    assert rc == 0, out
    lines = out.splitlines()
    op, s = _jax_expected(name, layout)
    assert lines[0] == "nlheat_unstructured (0.1.0)"
    assert lines[1].startswith(f"nodes {op.n} (dim 2), edges {len(op.tgt)}, ")
    assert lines[1].endswith(f"dt {op.dt:.3e}")
    err = s.error_l2 / op.n
    assert err <= 1e-6
    assert lines[2] == f"error_l2/N {err:.6e} (<= 1e-6)"
    assert lines[3] == f"l2: {s.error_l2:g} linfinity: {s.error_linf:g}"
    assert lines[4] == f"wrote {vtu}"
    assert lines[5] == "OS_Threads,Execution_Time_sec,Nodes,Time_Steps"
    assert lines[6].split(",")[2].strip() == str(op.n)
    data = tvtu.read_vtu_point_data(vtu)
    assert _rel(data["Temperature"], s.u) <= 1e-10
    assert np.array_equal(data["Points"].reshape(-1, 3)[:, :2], op.points)


def test_cli_results_input_and_refusals(monkeypatch, tmp_path):
    op, _ = _jax_expected("10x10", "edges", nt=5)
    u0 = np.random.default_rng(3).normal(size=op.n)
    monkeypatch.setattr(sys, "stdin", io.StringIO(" ".join(f"{v:.17g}" for v in u0)))
    rc, out = _run_cli(["--mesh", "data/10x10.msh", "--platform", "cpu", "--nt", "5",
                        "--layout", "edges", "--results", "--no-header", "--eps-h", "3"])
    assert rc == 0
    js = jun.UnstructuredSolver(op, nt=5, layout="edges")
    js.input_init(u0)
    js.do_work()
    vals = [float(v) for v in out.splitlines()[2:2 + op.n]]
    assert np.allclose(vals, js.u, rtol=1e-5, atol=1e-6)  # printed with %g
    assert "OS_Threads" not in out
    trace_dir = str(tmp_path)
    # --program-store publishes its directory in the env; restored at teardown
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", "0")
    for argv, what in (
        (["--devices", "2", "--superstep", "2"], "does not fit the sharded offsets form"),
        (["--halo", "export", "--superstep", "2"], "on a ShardedUnstructuredOp"),
        (["--superstep", "2"], "on a ShardedUnstructuredOp (offsets layout)"),
        # ported since: --trace writes its host trace (rc 0), --metrics-out
        # and --metrics-port get the JAX refusals of a bad value
        (["--trace", trace_dir], f"-> {tmp_path / 'host_trace.json'}"),
        (["--metrics-out", trace_dir], f"--metrics-out {trace_dir!r} is a directory"),
        (["--metrics-port", "70000"], "--metrics-port must be in [0, 65535] (got 70000)"),
        # ported since: the flight recorder and the program store run (rc 0)
        (["--flight-dir", str(tmp_path / "box")], "error_l2/N"),
        (["--program-store", str(tmp_path / "store")], "error_l2/N"),
        (["--gang-order", "1", "--devices", "4", "--superstep", "2"],
         "does not fit the sharded offsets form"),
    ):
        err = io.StringIO()
        monkeypatch.setattr(sys, "stderr", err)
        rc, out = _run_cli(["--mesh", "data/10x10.msh", "--test", "--platform", "cpu", *argv])
        runs = argv[0] in ("--trace", "--flight-dir", "--program-store")
        assert rc == (0 if runs else 1), (argv, err.getvalue())
        assert what in err.getvalue() + out, (argv, err.getvalue())
    assert (tmp_path / "host_trace.json").exists()
    assert (tmp_path / "box").is_dir()
