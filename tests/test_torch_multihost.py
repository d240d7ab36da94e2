"""The port's multi-process tier (parallel/multihost.py and the rank-aware
distributed modules) against the JAX package's, case by case after
tests/test_multihost.py.

Ranks are real processes (tests/torch_multihost_child.py) wired into one
``gloo`` group: children of one group meet at a ``file://`` URL in the
test's own directory; the CLI tests launch the CLIs as ``srun -n 2`` would,
through the JAX launch variables and ``tcp://localhost:<free port>``.  Every
group times out after at most 60 s and every spawn after a stated time,
killing its siblings when one rank fails.

Tolerances: every multi-process result bitwise the same solve in one process
(the children check it, on every rank) and equal on every rank
(``assert_same_on_all_hosts``); within 1e-12 of the JAX package's
one-process solve (float64; the JAX distributed solvers on conftest's 8
virtual CPU devices, the JAX unstructured oracle); ``_multiprocess_signals``
and ``host_block_slice`` equal the JAX functions.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.ops import unstructured as tu
from nonlocalheatequation_torch.parallel import multihost
from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh
from nonlocalheatequation_torch.utils.checkpoint import load_state
from nonlocalheatequation_tpu.ops import unstructured as ju
from nonlocalheatequation_tpu.parallel import distributed2d as jd2
from nonlocalheatequation_tpu.parallel import distributed3d as jd3
from nonlocalheatequation_tpu.parallel import mesh as jmesh
from nonlocalheatequation_tpu.parallel import multihost as jmultihost

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_multihost_child.py")
LAUNCH_VARS = ("COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "SLURM_NTASKS",
               "SLURM_PROCID", "TPU_WORKER_HOSTNAMES")
GROUP_TIMEOUT_S = 60  # every group's own collective timeout
SPAWN_TIMEOUT_S = 150  # every spawn's wall limit

LEGS_2D = [f"2d-eps{e}-{c}" for e in (3, 9) for c in ("collective", "fused")] + [
    "2d-rank0-only", "2d-rank0-only-fft", "2d-superstep2", "2d-rkc-perstage", "2d-rkc-batch2",
    "2d-fft-euler", "2d-fft-rkc", "2d-fft-expo"]
LEGS_3D = [f"3d-eps{e}-{c}" for e in (2, 5) for c in ("collective", "fused")]
LEGS_U = ["unstructured-offsets", "unstructured-export", "unstructured-gather",
          "unstructured-solver", "unstructured-superstep2"]
ALL_LEGS = LEGS_2D + LEGS_3D + LEGS_U


def _clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(OMP_NUM_THREADS="1", NLHEAT_DIST_TIMEOUT=str(GROUP_TIMEOUT_S))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn_children(tmp, dev_counts, legs="", **extra):
    """One child a rank, ``dev_counts[rank]`` virtual CPU devices each."""
    out = tmp / "out"
    out.mkdir(exist_ok=True)
    procs = []
    for pid, local in enumerate(dev_counts):
        env = _clean_env(TMH_LOCAL=local, TMH_NDEV=sum(dev_counts), TMH_OUT=out, **extra)
        if legs:
            env["TMH_LEGS"] = legs
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, f"file://{tmp / 'pg'}", str(len(dev_counts)), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    return procs


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()


def _harvest(procs, timeout=SPAWN_TIMEOUT_S) -> list:
    """Every rank's output; a rank that fails or outlives ``timeout`` kills
    its siblings (which would otherwise wait out the group timeout)."""
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            _kill(procs)
            out, _ = p.communicate()
            out = (out or "") + f"\n[parent] killed after {timeout} s"
        if p.returncode != 0:
            _kill(procs)
        outs.append(out or "")
    for p in procs:
        p.wait()
    return outs


def _run_loopback(tmp, dev_counts, legs="", **extra) -> list:
    outs = _harvest(_spawn_children(tmp, dev_counts, legs, **extra))
    for pid, out in enumerate(outs):
        assert "TMH-OK" in out or not legs.strip(), out[-2000:]
    return outs


def _ok(outs, pid, leg) -> bool:
    return f"TMH-OK p{pid} {leg}\n" in outs[pid] + "\n"


# -- the JAX package's one-process solves -----------------------------------------------

_JAX = {}


def _jax_leg(leg: str, ndev: int) -> np.ndarray:
    """The JAX package's one-process counterpart of a child's leg on
    ``ndev`` global devices (cached: the 2+2 and 3+1 runs share meshes)."""
    key = (leg, ndev)
    if key in _JAX:
        return _JAX[key]
    my, mz = ndev // 2, (ndev // 4 if ndev % 4 == 0 else 1)
    nx, ny = 16, 8 * my
    if leg.startswith("2d"):
        kw = dict(nt=3, eps=3, k=1.0, dt=1e-4, dh=1.0 / nx)
        if leg.startswith("2d-eps"):
            kw["eps"] = int(leg.split("-")[1][3:])
        kw.update({"2d-superstep2": dict(superstep=2),
                   "2d-rkc-perstage": dict(stepper="rkc", stages=4),
                   "2d-rkc-batch2": dict(stepper="rkc", stages=4, superstep=2),
                   "2d-fft-euler": dict(method="fft"),
                   "2d-rank0-only-fft": dict(method="fft"),
                   "2d-fft-rkc": dict(method="fft", stepper="rkc", stages=4),
                   "2d-fft-expo": dict(method="fft", stepper="expo", stages=1, dt=1e-3),
                   }.get(leg, {}))
        s = jd2.Solver2DDistributed(nx, ny, 1, 1, mesh=jmesh.make_mesh(2, my), **kw)
    elif leg.startswith("3d"):
        s = jd3.Solver3DDistributed(8, 8, 8, nt=2, eps=int(leg.split("-")[1][3:]), k=1.0,
                                    dt=1e-4, dh=0.05, mesh=jmesh.make_mesh_3d(2, 2, mz))
    else:
        pts, h = _cloud()
        jop = ju.UnstructuredNonlocalOp(pts, 3.0 * h, k=1.0, dt=1e-6, vol=h * h)
        if leg in ("unstructured-offsets", "unstructured-export", "unstructured-gather"):
            _JAX[key] = jop.apply_np(np.random.default_rng(1).normal(size=jop.n))
            return _JAX[key]
        s = ju.UnstructuredSolver(jop, nt=3, backend="oracle")
    s.test_init()
    _JAX[key] = np.asarray(s.do_work())
    return _JAX[key]


def _cloud(m=32, seed=0):
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    xs, ys = np.meshgrid(np.arange(m) * h, np.arange(m) * h, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    return pts, h


def _held_to_jax(out_dir, leg, ndev):
    got = np.load(out_dir / f"{leg}.npy")
    want = _jax_leg(leg, ndev)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < 1e-12, f"{leg}: {err:.3e} from the JAX one-process solve"


# -- one process: every helper is the single-process behaviour ---------------------------

def _no_launch(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)


def test_init_from_env_noop_single_process(monkeypatch):
    _no_launch(monkeypatch)
    assert multihost.init_from_env() is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert not multihost.initialized()


ENV_ROWS = [{}, {"SLURM_NTASKS": "1"}, {"SLURM_NTASKS": "4"}, {"SLURM_NTASKS": "x"},
            {"SLURM_NTASKS": "1", "TPU_WORKER_HOSTNAMES": "w0"},
            {"TPU_WORKER_HOSTNAMES": "w0,w1,w2,w3"}, {"COORDINATOR_ADDRESS": "h:1"},
            {"JAX_NUM_PROCESSES": "2"}, {"JAX_PROCESS_ID": "1"}]


@pytest.mark.parametrize("row", ENV_ROWS, ids=lambda r: ",".join(r) or "none")
def test_multiprocess_signals_match_jax(monkeypatch, row):
    _no_launch(monkeypatch)
    for k, v in row.items():
        monkeypatch.setenv(k, v)
    assert multihost._multiprocess_signals() == jmultihost._multiprocess_signals()


@pytest.mark.parametrize("n,P", [(100, 8), (64, 1), (7, 3), (16, 4), (5, 8)])
def test_host_block_slice_matches_jax(n, P):
    rows = [multihost.host_block_slice(n, axis_size=P, index=p) for p in range(P)]
    assert rows == [jmultihost.host_block_slice(n, axis_size=P, index=p) for p in range(P)]
    covered = np.zeros(n, int)
    for sl in rows:
        covered[sl] += 1
    assert (covered == 1).all()
    assert multihost.host_block_slice(n, axis_size=1, index=0) == slice(0, n)


def test_assert_same_noop_single_process():
    multihost.assert_same_on_all_hosts(np.arange(5), "params")
    multihost.assert_same_on_all_hosts(np.arange(5) + 1.5, "params")


def test_solver_on_global_mesh_single_process(monkeypatch):
    """The documented flow in one process: init_from_env (a no-op), the
    global device list, a mesh over it and a solve: no placeholder, and the
    JAX solve to 1e-12."""
    _no_launch(monkeypatch)
    multihost.init_from_env()
    devs = device_list("cpu", 4)
    assert not any(multihost.is_remote(d) for d in devs)
    mesh = make_mesh(devices=devs)
    assert (mesh.ranks == 0).all()
    s = Solver2DDistributed(8 * mesh.shape["x"], 8 * mesh.shape["y"], 1, 1, nt=5, eps=3,
                            dt=1e-5, dh=0.02, mesh=mesh, dtype=torch.float64)
    s.test_init()
    u = s.do_work()
    j = jd2.Solver2DDistributed(16, 16, 1, 1, nt=5, eps=3, dt=1e-5, dh=0.02,
                                mesh=jmesh.make_mesh(2, 2))
    j.test_init()
    assert np.abs(u - np.asarray(j.do_work())).max() < 1e-12


@pytest.mark.parametrize("counts,me,owners", [
    ([2, 2], 0, [[0, 0], [1, 1]]), ([2, 2], 1, [[0, 0], [1, 1]]),
    ([3, 1], 1, [[0, 0], [0, 1]]), ([3, 1], 0, [[0, 0], [0, 1]])])
def test_mesh_owners_follow_rank_order(monkeypatch, counts, me, owners):
    """The global device list is every rank's devices in rank order (the
    order of jax.devices()): with 2+2, mesh row x=0 is rank 0's; an uneven
    3+1 split crosses ranks mid-row.  Only this rank's positions hold
    blocks."""
    monkeypatch.setattr(multihost, "process_count", lambda: len(counts))
    monkeypatch.setattr(multihost, "process_index", lambda: me)
    monkeypatch.setattr(multihost, "all_gather_ints", lambda v: [[c, 0] for c in counts])
    monkeypatch.setattr("nonlocalheatequation_torch.parallel.mesh.process_count",
                        lambda: len(counts))
    monkeypatch.setattr("nonlocalheatequation_torch.parallel.mesh.process_index", lambda: me)
    devs = multihost.global_devices([torch.device("cpu")] * counts[me])
    mesh = make_mesh(2, 2, devs)
    assert mesh.ranks.tolist() == owners
    blocks = multihost.put_global(np.arange(16.0).reshape(4, 4), mesh, torch.float64)
    for pos in np.ndindex(2, 2):
        assert isinstance(blocks[pos], multihost.Remote) == (owners[pos[0]][pos[1]] != me)


# -- the two-controller loopback (2+2 devices) --------------------------------------------

@pytest.fixture(scope="module")
def loopback_2x2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh2x2")
    outs = _run_loopback(tmp, [2, 2], legs="2d,superstep,rkc,fft,3d,unstructured")
    return tmp / "out", outs


@pytest.mark.parametrize("leg", ALL_LEGS)
def test_two_controller_loopback_leg(loopback_2x2, leg):
    """Each leg on both ranks: bitwise the one-process port solve (checked in
    the children), the same on both ranks, and the JAX solve to 1e-12."""
    out_dir, outs = loopback_2x2
    for pid in range(2):
        assert _ok(outs, pid, leg), f"rank {pid}:\n{outs[pid][-2000:]}"
    _held_to_jax(out_dir, leg, 4)


@pytest.mark.parametrize("counts", [[2, 2, 2, 2], [3, 1]], ids=["4x2", "3+1"])
def test_four_controllers_and_an_uneven_split(tmp_path, counts):
    """Four controllers (meshes (2,4) and (2,2,2) across every rank
    boundary) and an uneven 3+1 split (the (2,2) mesh crosses ranks
    mid-row): every leg on every rank, each held to the JAX solve."""
    outs = _run_loopback(tmp_path, counts, legs="2d,superstep,rkc,fft,3d,unstructured")
    ndev = sum(counts)
    legs = [leg for leg in ALL_LEGS if not (ndev == 8 and leg == "unstructured-superstep2")]
    for leg in legs:
        for pid in range(len(counts)):
            assert _ok(outs, pid, leg), f"rank {pid}, {leg}:\n{outs[pid][-2000:]}"
        _held_to_jax(tmp_path / "out", leg, ndev)


# -- the CLIs launched like srun -------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_cli(args, n=2, stdin=None, stderr=subprocess.PIPE):
    port = _free_port()
    procs = []
    for pid in range(n):
        env = _clean_env(COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=n,
                         JAX_PROCESS_ID=pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", *args], stdin=subprocess.PIPE if stdin else None,
            stdout=subprocess.PIPE, stderr=stderr, text=True, env=env, cwd=REPO))
    if stdin:
        try:
            for pid, p in enumerate(procs):
                # close every rank's stdin now: a rank blocked in read() would
                # leave its peers waiting in the first collective
                p.stdin.write(stdin[pid])
                p.stdin.close()
                p.stdin = None
        except BrokenPipeError:
            _kill(procs)
    return procs


def _harvest_cli(procs, timeout=SPAWN_TIMEOUT_S, expect_failure=False):
    """Every rank's (rc, stdout, stderr); a rank that outlives ``timeout``,
    or fails where no failure is expected, kills its siblings."""
    deadline = time.monotonic() + timeout
    res = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            _kill(procs)
            out, err = p.communicate()
            err = (err or "") + f"\n[parent] killed after {timeout} s"
        if p.returncode != 0 and not expect_failure:
            _kill(procs)
        res.append((p.returncode, out or "", err or ""))
    return res


@pytest.mark.parametrize("cli_args, banner, footer", [
    (["nonlocalheatequation_torch.cli.solve2d_distributed",
      "--nx", "8", "--ny", "8", "--npx", "2", "--npy", "2",
      "--nt", "5", "--eps", "3", "--dt", "0.0005", "--dh", "0.02"],
     "2d_nonlocal_distributed", "Localities"),
    (["nonlocalheatequation_torch.cli.solve3d", "--distributed", "--test",
      "--nx", "8", "--ny", "8", "--nz", "8", "--nt", "2", "--eps", "2",
      "--dt", "0.0001", "--dh", "0.05"],
     "3d_nonlocal", "z dimension"),
], ids=["solve2d_distributed", "solve3d"])
def test_cli_runs_multicontroller_like_srun(cli_args, banner, footer):
    """Every rank runs the same CLI (``--devices 2`` each): rank 0 prints the
    banner, the error report and the footer; rank 1 nothing but the
    transport's own connection chatter."""
    res = _harvest_cli(_launch_cli(cli_args + ["--platform", "cpu", "--devices", "2"]))
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, f"rank {pid}:\n{out[-1500:]}\n[stderr]\n{err[-1500:]}"
    out0 = res[0][1]
    assert banner in out0 and "l2:" in out0 and footer in out0, out0
    noise = [ln for ln in res[1][1].splitlines() if ln.strip() and not ln.startswith("[Gloo]")]
    assert noise == [], f"rank 1 printed to stdout:\n{noise[:5]}"


def test_cli_batch_multicontroller_verifies_token_stream():
    """--test_batch under two ranks: identical stdin passes (rank 0 prints
    the verdict); divergent stdin fails on every rank with "batch input"."""
    batch = "1\n25 25 2 2 45 5 1 0.0005 0.02\n"
    args = ["nonlocalheatequation_torch.cli.solve2d_distributed", "--test_batch",
            "--platform", "cpu", "--devices", "2"]
    res = _harvest_cli(_launch_cli(args, stdin=[batch, batch]))
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, f"rank {pid}:\n{out[-1500:]}\n{err[-1500:]}"
    assert res[0][1].splitlines()[-1] == "Tests Passed"
    odd = "1\n25 25 2 2 45 5 1 0.0006 0.02\n"  # one token off
    res = _harvest_cli(_launch_cli(args, stdin=[batch, odd]), expect_failure=True)
    for pid, (rc, _out, err) in enumerate(res):
        assert rc != 0, f"rank {pid} missed the divergence"
        assert "batch input" in err, err[-1500:]


def test_assert_same_detects_divergence(tmp_path):
    """The check raises when ranks hold different values, under an uneven
    1+2 split, and passes identical float64 values."""
    code = (
        "import sys, numpy as np, torch\n"
        "sys.path.insert(0, sys.argv[4])\n"
        "from nonlocalheatequation_torch.parallel import multihost\n"
        "from nonlocalheatequation_torch.parallel.mesh import device_list\n"
        "multihost.init_from_env(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),\n"
        "                        platform='cpu', timeout=60)\n"
        "assert len(device_list('cpu', 1 + int(sys.argv[3]))) == 3\n"
        "multihost.assert_same_on_all_hosts(np.arange(3.0) + 0.123456789, 'same-f64')\n"
        "try:\n"
        "    multihost.assert_same_on_all_hosts(np.arange(3.0) + multihost.process_index(),\n"
        "                                       'divergent')\n"
        "    print('NO-RAISE')\n"
        "except AssertionError as e:\n"
        "    print('RAISED-OK' if 'differs between hosts (process' in str(e) else str(e))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, f"file://{tmp_path / 'pg'}", "2",
                               str(pid), REPO], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_clean_env())
             for pid in range(2)]
    for pid, out in enumerate(_harvest(procs)):
        assert "RAISED-OK" in out and "NO-RAISE" not in out, f"rank {pid}:\n{out[-1500:]}"


@pytest.mark.parametrize("flag", [["--file", "data_4.txt"], ["--nbalance", "2"],
                                  ["--test_load_balance"]])
def test_elastic_flags_refused_under_two_ranks(flag):
    args = ["nonlocalheatequation_torch.cli.solve2d_distributed", "--platform", "cpu",
            "--nt", "1"] + flag
    for pid, (rc, _out, err) in enumerate(_harvest_cli(_launch_cli(args), expect_failure=True)):
        assert rc == 1, f"rank {pid}: rc {rc}\n{err[-1500:]}"
        assert "the elastic executor, which is single-controller" in err, err[-1500:]


# -- kill one rank, then resume on one and on four ---------------------------------------

def _crash(tmp_path, leg):
    """A 2-rank checkpointed run killed mid-flight (rank 1 first, then the
    rest); returns the checkpoint it left."""
    ck = tmp_path / f"{leg}.npz"
    procs = _spawn_children(tmp_path, [2, 2], leg, TMH_CK=ck)
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ck.exists() and time.monotonic() < deadline:
            if all(p.poll() is not None for p in procs):
                break
            time.sleep(0.1)
        assert ck.exists(), "no checkpoint appeared"
        procs[1].send_signal(signal.SIGKILL)
        time.sleep(0.5)
    finally:
        _kill(procs)
    _harvest(procs, timeout=30)
    u, t, _ = load_state(str(ck))
    assert t > 0
    return ck, u, t


def test_kill_one_then_resume_unstructured(tmp_path):
    """The sharded unstructured run killed under two ranks resumes in one
    process (the unsharded operator) and on four ranks, each to 1e-12 of
    the oracle's whole trajectory."""
    ck, u, t = _crash(tmp_path, "crashu")
    assert u.shape == (1024,)
    nt_total = t + 4
    pts, h = _cloud()
    op = tu.UnstructuredNonlocalOp(pts, 3.0 * h, k=1.0, dt=1e-6, vol=h * h, device="cpu")
    s = tu.UnstructuredSolver(op, nt=nt_total, dtype=torch.float64)
    s.test_init()
    s.resume(str(ck))
    assert s.t0 == t
    o = tu.UnstructuredSolver(op, nt=nt_total, backend="oracle")
    o.test_init()
    assert np.abs(s.do_work() - o.do_work()).max() < 1e-12
    (tmp_path / "resume").mkdir()
    outs = _run_loopback(tmp_path / "resume", [2, 2, 2, 2], "resumeu", TMH_CK=ck,
                         TMH_NT_TOTAL=nt_total)
    for pid in range(4):
        assert f"TMH-OK p{pid} resumeu t0={t} " in outs[pid], outs[pid][-2000:]


def test_kill_one_then_resume_2d(tmp_path):
    """The 2D grid pair: killed under two ranks, resumed in one process
    (Solver2D, torch) and on four ranks, each to 1e-12 of the oracle."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D

    ck, u, t = _crash(tmp_path, "crash2d")
    assert u.shape == (16, 16)
    nt_total = t + 4
    kw = dict(k=1.0, dt=1e-4, dh=1.0 / 16)
    s = Solver2D(16, 16, nt_total, 3, device="cpu", dtype=torch.float64, **kw)
    s.test_init()
    s.resume(str(ck))
    assert s.t0 == t
    o = Solver2D(16, 16, nt_total, 3, backend="oracle", device="cpu", **kw)
    o.test_init()
    assert np.abs(s.do_work() - o.do_work()).max() < 1e-12
    (tmp_path / "resume").mkdir()
    outs = _run_loopback(tmp_path / "resume", [2, 2, 2, 2], "resume2d", TMH_CK=ck,
                         TMH_NT_TOTAL=nt_total)
    for pid in range(4):
        assert f"TMH-OK p{pid} resume2d t0={t} " in outs[pid], outs[pid][-2000:]
