"""The port stands alone: no JAX, no JAX package, no quiet CPU fallback.

* A subprocess with ``jax`` and ``nonlocalheatequation_tpu`` blocked in
  ``sys.modules`` imports every module of the port and chip_smoke.py and
  runs a small 2D and 3D CPU solve, an rkc and an expo (fft) 2D solve
  (models/steppers.py, ops/spectral.py), a 2-case ensemble, a small windowed
  unstructured solve, a 2-case mesh-bucket ensemble, the distributed
  2D (fused) and 3D solves on meshes of virtual CPU devices, an elastic
  solve that rebalances over 2 virtual CPU devices, a throttled
  Solver2D (``nd``), a checkpoint round trip, solve2d_async's batch, a
  2-case stream through the serving pipeline (under a fault plan, with a
  tracer and the event log) and solve2d's ``--serve``.
* No source file of the port names either package in an import; the
  distributed slice's modules (parallel/multihost.py among them), the
  serving slice's (serve/server.py, serve/resilience.py, utils/faults.py,
  obs/export.py, obs/metrics.py, obs/trace.py), the fleet's leaves
  (obs/flightrec.py, obs/slo.py, serve/picker.py, serve/program_store.py),
  the fleet's front door (serve/transport.py, serve/router.py,
  serve/http.py, parallel/mesh_axes.py; the transport stdlib only), the
  live-session tier (serve/sessions.py) and the multi-process test child
  are among them.
* ``init_from_env`` with no launch signal never wires a process group.
* The entry points default to the card: without one they raise (or the
  CLIs exit 2), the distributed solvers, meshes and CLIs included, and so
  do ``ServePipeline()`` and ``--serve`` on the batch CLIs.
* chip_smoke.py on a host without a CUDA card exits non-zero and prints no
  result line.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "nonlocalheatequation_torch"

BLOCKED_RUN = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["nonlocalheatequation_tpu"] = None
import nonlocalheatequation_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from nonlocalheatequation_torch.models.solver2d import Solver2D
s = Solver2D(24, 24, 10, 4, device="cpu", method="cuda")
s.test_init()
s.do_work()
assert s.error_l2 / 24**2 <= 1e-6, s.error_l2
from nonlocalheatequation_torch.models.solver3d import Solver3D
s = Solver3D(10, 9, 8, 6, 2, device="cpu", method="cuda")
s.test_init()
s.do_work()
assert s.error_l2 / (10 * 9 * 8) <= 1e-6, s.error_l2
for kw in (dict(dt=1e-4, method="cuda", stepper="rkc", stages=4),
           dict(dt=2e-5, method="fft", stepper="expo")):
    s = Solver2D(24, 24, 10, 4, device="cpu", **kw)
    s.test_init()
    s.do_work()
    assert s.error_l2 / 24**2 <= 1e-6, (kw, s.error_l2)
from nonlocalheatequation_torch.serve.ensemble import run_test_cases, EnsembleCase, EnsembleEngine
errs = run_test_cases([EnsembleCase(shape=(20, 18), nt=4, eps=3, k=k, dt=1e-4, dh=0.05)
                       for k in (1.0, 0.5)], method="cuda", device="cpu")
assert all(e / n <= 1e-6 for e, n in errs), errs
import os, tempfile
import numpy as np
from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp, UnstructuredSolver
from nonlocalheatequation_torch.serve.meshes import MeshStore
ii, jj = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
pts = np.stack([ii.ravel(), jj.ravel()], axis=1) / 16.0
op = UnstructuredNonlocalOp(pts, 3 / 16.0, k=1.0, dt=1e-4, vol=1 / 256.0, device="cpu")
s = UnstructuredSolver(op, nt=8, layout="windowed")
s.test_init()
s.do_work()
assert s.error_l2 / op.n <= 1e-6, s.error_l2
os.environ["NLHEAT_MESH_DIR"] = tempfile.mkdtemp()
mhash = MeshStore(os.environ["NLHEAT_MESH_DIR"]).put(pts, 3 / 16.0, 1 / 256.0)
errs = run_test_cases([EnsembleCase(shape=(256,), nt=4, eps=0, k=k, dt=1e-4, dh=0.0, mesh=mhash)
                       for k in (1.0, 0.5)], device="cpu")
assert all(e / n <= 1e-6 for e, n in errs), errs
from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d
from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
s = Solver2DDistributed(8, 8, 2, 2, 3, 2, dh=0.05, method="cuda", comm="fused",
                        mesh=make_mesh(2, 2, device_list("cpu", 4)))
s.test_init()
s.do_work()
assert s.error_l2 / 256 <= 1e-6, s.error_l2
s = Solver3DDistributed(8, 8, 8, 3, 2, method="cuda", comm="fused",
                        mesh=make_mesh_3d(2, 2, 2, device_list("cpu", 8)))
s.test_init()
s.do_work()
assert s.error_l2 / 512 <= 1e-6, s.error_l2
from nonlocalheatequation_torch.parallel.elastic import ElasticSolver2D
s = ElasticSolver2D(5, 5, 4, 4, 6, 2, nbalance=3, dh=0.05, method="cuda",
                    devices=device_list("cpu", 2))
s.test_init()
s.do_work()
assert s.error_l2 / 400 <= 1e-6, s.error_l2
s = Solver2D(20, 20, 12, 3, k=0.2, dt=0.001, device="cpu", method="cuda", nd=3)
s.test_init()
s.do_work()
assert s.max_inflight_ == 3 and s.error_l2 / 400 <= 1e-6, (s.max_inflight_, s.error_l2)
from nonlocalheatequation_torch.utils.checkpoint import load_state
path = os.path.join(tempfile.mkdtemp(), "state.npz")
s = Solver2D(20, 20, 8, 3, device="cpu", checkpoint_path=path, ncheckpoint=4)
s.test_init()
s.do_work()
r = Solver2D(20, 20, 12, 3, device="cpu")
r.test_init()
r.resume(path)
assert r.t0 == 8 and load_state(path)[0].shape == (20, 20)
r.do_work()
import io
from nonlocalheatequation_torch.cli import solve2d_async
sys.stdin = io.StringIO("1\\n1 1 20 40 5 0.2 0.001 0.02\\n")
assert solve2d_async.main(["--test_batch", "--platform", "cpu"]) == 0
from nonlocalheatequation_torch.obs.trace import Tracer
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_torch.utils.faults import FaultPlan
os.environ["NLHEAT_EVENT_LOG"] = os.path.join(tempfile.mkdtemp(), "events.jsonl")
cases = [EnsembleCase(shape=(16, 16), nt=3, eps=2, k=k, dt=1e-4, dh=0.05, test=False,
                      u0=np.full((16, 16), 1.0)) for k in (1.0, 0.5)]
tracer = Tracer()
with ServePipeline(depth=2, window_ms=0.0, device="cpu", method="cuda", retries=1,
                   backoff_ms=0.0, faults=FaultPlan.parse("raise@0"), tracer=tracer) as pipe:
    served = pipe.serve_cases(cases)
want = EnsembleEngine(device="cpu", method="cuda").run(cases)
assert all(np.array_equal(a, b) for a, b in zip(served, want))
assert pipe.report.retries == 1 and tracer.spans_total > 0
assert pipe.registry.prometheus().startswith("# TYPE")
del os.environ["NLHEAT_EVENT_LOG"]
from nonlocalheatequation_torch.cli import solve2d
sys.stdin = io.StringIO("2\\n20 20 5 3 1 0.0005 0.05\\n20 20 5 3 0.5 0.0005 0.05\\n")
assert solve2d.main(["--test_batch", "--serve", "2", "--platform", "cpu"]) == 0
assert not any(m == "jax" or m.startswith(("jax.", "nonlocalheatequation_tpu"))
               for m, v in sys.modules.items() if v is not None)
print("imported", len(names))
"""


def test_port_imports_and_solves_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 35


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tests" / "torch_multihost_child.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "nonlocalheatequation_tpu"), (path, m)


DISTRIBUTED_SLICE = ("parallel/mesh.py", "parallel/halo.py", "parallel/distributed2d.py",
                     "parallel/distributed3d.py", "ops/cuda_halo.py",
                     "cli/solve2d_distributed.py", "utils/partition_map.py",
                     "utils/decompose.py", "cli/decompose.py", "parallel/load_balance.py",
                     "parallel/elastic.py", "parallel/gang.py", "parallel/multihost.py")
#: the port's copy of a NumPy-only JAX module, importing no torch either
NUMPY_ONLY = ("utils/partition_map.py",)


def test_the_distributed_slice_imports_neither_package():
    for rel in DISTRIBUTED_SLICE:
        tree = ast.parse((PKG / rel).read_text(), rel)
        roots = {(a.name if isinstance(node, ast.Import) else node.module or "").split(".")[0]
                 for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
                 for a in (node.names if isinstance(node, ast.Import) else [node])}
        if rel in NUMPY_ONLY:
            assert roots == {"__future__", "dataclasses", "numpy"}, (rel, roots)
        else:
            assert "nonlocalheatequation_torch" in roots or "torch" in roots, rel
        assert not roots & {"jax", "jaxlib", "nonlocalheatequation_tpu"}, (rel, roots)


SERVING_SLICE = ("serve/server.py", "serve/resilience.py", "utils/faults.py", "obs/export.py",
                 "obs/metrics.py", "obs/trace.py", "cli/common.py")
#: the port's copies of JAX modules that need neither JAX nor torch
STDLIB_NUMPY_ONLY = {"serve/resilience.py": {"__future__", "time", "collections"},
                     "utils/faults.py": {"__future__", "os", "threading", "dataclasses", "numpy"},
                     "obs/export.py": {"__future__", "heapq", "json", "os", "sys", "threading",
                                       "time", "http"},
                     "obs/metrics.py": {"__future__", "json", "re", "threading", "collections",
                                        "numpy"},
                     "obs/trace.py": {"__future__", "json", "os", "socket", "sys", "threading",
                                      "time", "collections"}}


def test_the_serving_slice_imports_neither_package():
    for rel in SERVING_SLICE:
        tree = ast.parse((PKG / rel).read_text(), rel)
        roots = {(a.name if isinstance(node, ast.Import) else node.module or "").split(".")[0]
                 for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
                 for a in (node.names if isinstance(node, ast.Import) else [node])}
        assert not roots & {"jax", "jaxlib", "nonlocalheatequation_tpu"}, (rel, roots)
        if rel in STDLIB_NUMPY_ONLY:
            assert roots == STDLIB_NUMPY_ONLY[rel], (rel, roots)


FLEET_LEAVES = ("obs/flightrec.py", "obs/slo.py", "serve/picker.py", "serve/program_store.py")
#: the leaves' own imports: the flight recorder is stdlib only, the picker
#: imports no torch (it never touches the card)
LEAF_ROOTS = {"obs/flightrec.py": {"__future__", "json", "os", "signal", "socket", "sys",
                                   "threading", "time", "collections"},
              "serve/picker.py": {"__future__", "math", "os", "dataclasses", "numpy",
                                  "nonlocalheatequation_torch"}}


def test_the_fleet_leaves_import_neither_package():
    for rel in FLEET_LEAVES:
        tree = ast.parse((PKG / rel).read_text(), rel)
        roots = {(a.name if isinstance(node, ast.Import) else node.module or "").split(".")[0]
                 for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
                 for a in (node.names if isinstance(node, ast.Import) else [node])}
        assert not roots & {"jax", "jaxlib", "nonlocalheatequation_tpu"}, (rel, roots)
        if rel in LEAF_ROOTS:
            assert roots == LEAF_ROOTS[rel], (rel, roots)


FRONT_DOOR = ("serve/transport.py", "serve/router.py", "serve/http.py",
              "parallel/mesh_axes.py", "serve/sessions.py")
#: the transport is stdlib only: the frame protocol never needs torch
FRONT_DOOR_ROOTS = {"serve/transport.py": {"__future__", "hmac", "ipaddress", "json", "pickle",
                                           "signal", "socket", "struct", "subprocess", "sys",
                                           "threading", "time"}}


def test_the_fleet_front_door_imports_neither_package():
    for rel in FRONT_DOOR:
        tree = ast.parse((PKG / rel).read_text(), rel)
        roots = {(a.name if isinstance(node, ast.Import) else node.module or "").split(".")[0]
                 for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
                 for a in (node.names if isinstance(node, ast.Import) else [node])}
        assert not roots & {"jax", "jaxlib", "nonlocalheatequation_tpu"}, (rel, roots)
        if rel in FRONT_DOOR_ROOTS:
            assert roots == FRONT_DOOR_ROOTS[rel], (rel, roots)
    from nonlocalheatequation_torch.serve import transport

    assert transport.WORKER_MODULE == "nonlocalheatequation_torch.serve.router"


def test_serving_entry_points_default_to_the_card(monkeypatch, capsys):
    import io

    import torch

    from nonlocalheatequation_torch.cli import solve1d, solve2d, solve3d
    from nonlocalheatequation_torch.serve.server import ServePipeline

    if torch.cuda.is_available():
        with ServePipeline(depth=1) as pipe:
            assert pipe.engine.device.type == "cuda"
        return
    try:
        ServePipeline(depth=2)
    except RuntimeError as e:
        assert "is_available() is false" in str(e)
    else:
        raise AssertionError("ServePipeline ran on the CPU without being asked to")
    for main, row in ((solve1d.main, "50 45 5 1.0 0.001 0.02"),
                      (solve2d.main, "50 50 45 5 1.0 0.0005 0.02"),
                      (solve3d.main, "8 8 8 4 2 1.0 0.0005 0.1")):
        monkeypatch.setattr("sys.stdin", io.StringIO(f"1\n{row}\n"))
        assert main(["--test_batch", "--serve", "2"]) == 2
        assert "is_available() is false" in capsys.readouterr().err


def test_the_front_door_defaults_to_the_card(monkeypatch, capsys):
    """ReplicaRouter() and --listen take the card: without one they refuse
    before any worker is spawned (the router builds the kernels once, on the
    card's behalf, and never on the CPU's), the session tier's flags
    included."""
    import io

    import torch

    from nonlocalheatequation_torch.cli import solve2d
    from nonlocalheatequation_torch.serve.router import ReplicaRouter

    if torch.cuda.is_available():
        return
    spawned = []
    monkeypatch.setattr(ReplicaRouter, "_spawn", lambda self, gang=False: spawned.append(1))
    try:
        ReplicaRouter(replicas=2)
    except RuntimeError as e:
        assert "is_available() is false" in str(e)
    else:
        raise AssertionError("ReplicaRouter ran on the CPU without being asked to")
    assert spawned == []
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert solve2d.main(["--listen", "0", "--replicas", "2"]) == 2
    assert "is_available() is false" in capsys.readouterr().err
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert solve2d.main(["--listen", "0", "--session-chunk", "4", "--session-rate", "100",
                         "--session-checkpoint-dir", "unused", "--session-checkpoint-every",
                         "2", "--session-preview", "2", "--session-budget", "8"]) == 2
    assert "is_available() is false" in capsys.readouterr().err
    assert spawned == []


def test_distributed_entry_points_default_to_the_card():
    import torch

    from nonlocalheatequation_torch.cli import solve2d_async, solve2d_distributed
    from nonlocalheatequation_torch.parallel import distributed2d, distributed3d, elastic, mesh

    if torch.cuda.is_available():
        assert mesh.device_list()[0].type == "cuda"
        return
    for call in (lambda: mesh.device_list(), lambda: mesh.make_mesh(),
                 lambda: mesh.make_mesh_3d(),
                 lambda: distributed2d.Solver2DDistributed(4, 4, 2, 2, 1, 1),
                 lambda: distributed3d.Solver3DDistributed(4, 4, 4, 1, 1),
                 lambda: distributed2d.choose_mesh_for_grid(8, 8),
                 lambda: elastic.ElasticSolver2D(4, 4, 2, 2, 1, 1)):
        try:
            call()
        except RuntimeError as e:
            assert "is_available() is false" in str(e)
        else:
            raise AssertionError("an entry point ran on the CPU without being asked to")
    assert solve2d_distributed.main(["--nt", "1"]) == 2
    assert solve2d_async.main(["--nt", "1"]) == 2


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "is_available() is false" in r.stderr


def test_init_from_env_without_a_signal_never_wires_a_group(monkeypatch):
    """No launch variable and no argument: init_from_env returns False and
    never reaches torch.distributed.init_process_group."""
    import torch.distributed as dist

    from nonlocalheatequation_torch.parallel import multihost

    for var in ("COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "SLURM_NTASKS",
                "SLURM_PROCID", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    for platform in (None, "cpu", "gpu"):
        assert multihost.init_from_env(platform=platform) is False
    assert calls == [] and not multihost.initialized()
