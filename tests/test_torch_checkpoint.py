"""The port's checkpoints (utils/checkpoint.py), case for case against
tests/test_checkpoint.py, and across the two packages, on the CPU.

* Interrupted + resumed equals uninterrupted BITWISE for Solver2D (the
  chunked and the throttled paths), Solver3D, Solver2DDistributed on a 2x2
  mesh and Solver3DDistributed on 2x2x2 of virtual CPU devices, and
  UnstructuredSolver (every layout).
* A parameter mismatch and an unknown version are refused; a truncated
  file and a corrupt payload are refused with the JAX message
  (``CORRUPT_HINT``); a write killed midway leaves the previous file
  loadable; a v1 file without a CRC loads, and legacy nx/ny parameters
  translate.
* The CLIs' --checkpoint/--resume on solve2d, solve3d and
  solve2d_distributed, with the JAX checks.
* Across the packages (float64): a file written by the JAX ``save_state``
  resumes in the port and ends within 1e-12 (relative to the largest
  magnitude) of the JAX uninterrupted run; a port file resumes in the JAX
  package to the same 1e-12; a distributed checkpoint resumes in Solver2D.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.cli import solve2d, solve2d_distributed, solve3d
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp, UnstructuredSolver
from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d
from nonlocalheatequation_torch.serve import meshes
from nonlocalheatequation_torch.utils import checkpoint as ckpt
from nonlocalheatequation_tpu.models.solver2d import Solver2D as JaxSolver2D
from nonlocalheatequation_tpu.utils import checkpoint as jckpt

torch.set_num_threads(1)
CPU = "cpu"


def _solver(nt, **kw):
    return Solver2D(20, 20, nt, eps=3, k=1.0, dt=1e-4, dh=0.05, device=CPU, **kw)


def _interrupted(make, path, nt, stop, every):
    """(uninterrupted, resumed) final states: the second run stopped after
    ``stop`` steps, its last checkpoint there or before, then resumed."""
    full = make(nt)
    full.test_init()
    full.do_work()
    first = make(nt, checkpoint_path=path, ncheckpoint=every)
    first.test_init()
    first.nt = stop  # "crash" after stop steps
    first.do_work()
    second = make(nt, checkpoint_path=path, ncheckpoint=every)
    second.test_init()
    second.resume(path)
    assert second.t0 == stop // every * every
    second.do_work()
    return full, second


def test_roundtrip(tmp_path):
    path = str(tmp_path / "state.npz")
    u = np.random.default_rng(0).normal(size=(5, 7))
    ckpt.save_state(path, u, 13, {"eps": 3})
    u2, t, params = ckpt.load_state(path)
    assert t == 13 and params["eps"] == 3
    assert (u2 == u).all() and u2.dtype == np.float64
    u32 = u.astype(np.float32)
    ckpt.save_state(path, u32, 2, {})
    u2, _, _ = ckpt.load_state(path)
    assert u2.dtype == np.float32 and (u2 == u32).all()  # saved in the state's own dtype


@pytest.mark.parametrize("nd", [None, 3])
def test_interrupted_equals_uninterrupted(tmp_path, nd):
    full, second = _interrupted(lambda nt, **kw: _solver(nt, nd=nd, method="cuda", **kw),
                                str(tmp_path / "state.npz"), 20, 10, 10)
    assert (second.u == full.u).all()  # bit for bit
    assert second.error_l2 == pytest.approx(full.error_l2)


def test_checkpoints_and_logs_share_the_barriers(tmp_path):
    """A logger and checkpoints together: the logged steps and the saved
    states are the per-step loop's, and the state is bitwise the unlogged
    run's, on the chunked path and the throttled one."""
    seen = {}
    for nd in (None, 2):
        path = str(tmp_path / f"s{nd}.npz")
        log = []
        s = _solver(11, nd=nd, checkpoint_path=path, ncheckpoint=4,
                    logger=lambda t, u, log=log: log.append((t, u)))
        s.nlog = 3
        s.test_init()
        s.do_work()
        seen[nd] = (log, s.u, ckpt.load_state(path))
    ref = _solver(11)
    ref.test_init()
    ref.do_work()
    for log, u, (saved, t, params) in seen.values():
        assert [t for t, _ in log] == [0, 3, 6, 9]
        assert np.array_equal(u, ref.u) and t == 8 and params["shape"] == [20, 20]
        part = _solver(8)
        part.test_init()
        assert np.array_equal(saved, part.do_work())


def test_param_mismatch_refuses(tmp_path):
    path = str(tmp_path / "state.npz")
    s = _solver(10, checkpoint_path=path, ncheckpoint=5)
    s.test_init()
    s.do_work()
    other = Solver2D(20, 20, 20, eps=4, k=1.0, dt=1e-4, dh=0.05, device=CPU)
    other.test_init()
    with pytest.raises(ValueError, match="mismatch"):
        other.resume(path)
    free = _solver(20)  # the test flag is a parameter too
    with pytest.raises(ValueError, match="mismatch: test"):
        free.resume(path)
    short = _solver(5)
    short.test_init()
    with pytest.raises(ValueError, match="beyond nt=5"):
        short.resume(path)


def test_version_guard(tmp_path):
    path = str(tmp_path / "state.npz")
    ckpt.save_state(path, np.zeros((2, 2)), 0, {})
    with np.load(path) as z:
        data = dict(z)
    data["version"] = np.int64(99)
    with open(path, "wb") as f:
        np.savez(f, **data)
    with pytest.raises(ValueError, match="version"):
        ckpt.load_state(path)


def test_truncated_checkpoint_refused_with_the_jax_message(tmp_path):
    assert ckpt.CORRUPT_HINT == jckpt.CORRUPT_HINT
    path = str(tmp_path / "state.npz")
    ckpt.save_state(path, np.random.default_rng(1).normal(size=(16, 16)), 7, {"eps": 3})
    blob = open(path, "rb").read()
    for cut in (0, 10, len(blob) // 2, len(blob) - 8):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(ValueError) as ours:
            ckpt.load_state(path)
        with pytest.raises(ValueError) as theirs:
            jckpt.load_state(path)
        assert str(ours.value) == str(theirs.value)
        assert str(ours.value).endswith(ckpt.CORRUPT_HINT)


def test_corrupt_payload_fails_integrity_check(tmp_path):
    path = str(tmp_path / "state.npz")
    ckpt.save_state(path, np.random.default_rng(2).normal(size=(16, 16)), 7, {"eps": 3})
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # inside the uncompressed state payload
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="integrity|previous checkpoint") as ours:
        ckpt.load_state(path)
    with pytest.raises(ValueError) as theirs:
        jckpt.load_state(path)
    assert str(ours.value) == str(theirs.value)


def test_kill_mid_write_leaves_previous_checkpoint_loadable(tmp_path, monkeypatch):
    path = str(tmp_path / "state.npz")
    u1 = np.random.default_rng(3).normal(size=(8, 8))
    ckpt.save_state(path, u1, 5, {"eps": 3})

    def dying_savez(f, **kw):
        f.write(b"partial garbage")
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_state(path, np.zeros((8, 8)), 6, {"eps": 3})
    monkeypatch.undo()
    monkeypatch.setattr(ckpt.os, "replace",
                        lambda *a: (_ for _ in ()).throw(KeyboardInterrupt))
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_state(path, np.zeros((8, 8)), 6, {"eps": 3})
    monkeypatch.undo()
    u2, t, params = ckpt.load_state(path)
    assert t == 5 and (u2 == u1).all() and params["eps"] == 3
    assert [p.name for p in tmp_path.iterdir() if ".tmp." in p.name] == []


def test_the_mesh_store_writes_through_the_same_atomic_file():
    assert meshes.atomic_file is ckpt.atomic_file


def test_v1_checkpoint_without_crc_still_loads(tmp_path):
    path = str(tmp_path / "state.npz")
    u = np.arange(6.0).reshape(2, 3)
    with open(path, "wb") as f:
        np.savez(f, u=u, t=np.int64(4), version=np.int64(1),
                 params=np.frombuffer(json.dumps({"eps": 2}).encode(), dtype=np.uint8))
    u2, t, params = ckpt.load_state(path)
    assert t == 4 and (u2 == u).all() and params["eps"] == 2


def test_legacy_nx_ny_params_translate_to_shape(tmp_path):
    path = str(tmp_path / "state.npz")
    s = _solver(10)
    s.test_init()
    legacy = {k: v for k, v in s._ckpt_params().items() if k != "shape"}
    legacy["nx"], legacy["ny"] = s._grid_shape
    ckpt.save_state(path, s.u0, 0, legacy)
    _, _, params = ckpt.load_state(path)
    assert params["shape"] == list(s._grid_shape)
    s.resume(path)
    assert s.t0 == 0


def test_params_are_the_jax_solvers(tmp_path):
    ours = _solver(10)
    ours.test_init()
    theirs = JaxSolver2D(20, 20, 10, eps=3, k=1.0, dt=1e-4, dh=0.05, backend="jit")
    theirs.test_init()
    assert ours._ckpt_params() == theirs._ckpt_params()


def test_solver3d_checkpoint_resume_bit_identical(tmp_path):
    def make(nt, **kw):
        return Solver3D(10, 10, 10, nt, eps=2, k=0.5, dt=1e-4, dh=0.1, method="cuda",
                        device=CPU, **kw)

    full, second = _interrupted(make, str(tmp_path / "c3.npz"), 12, 7, 5)
    assert np.array_equal(full.u, second.u)


@pytest.mark.parametrize("comm", ["collective", "fused"])
def test_distributed_interrupted_equals_uninterrupted(tmp_path, comm):
    def make(nt, **kw):
        return Solver2DDistributed(10, 10, 2, 2, nt, eps=3, k=1.0, dt=1e-4, dh=0.05,
                                   mesh=make_mesh(2, 2, device_list(CPU, 4)), method="cuda",
                                   comm=comm, **kw)

    path = str(tmp_path / "dist.npz")
    full, second = _interrupted(make, path, 20, 10, 10)
    assert (second.u == full.u).all()
    # the global state and the single-device parameters: Solver2D resumes it
    serial = _solver(20, method="cuda")
    serial.test_init()
    serial.resume(path)
    serial.do_work()
    assert np.max(np.abs(serial.u - full.u)) <= 1e-12 * np.max(np.abs(full.u))


def test_serial_checkpoint_resumes_in_the_distributed_solver(tmp_path):
    path = str(tmp_path / "serial.npz")
    s = _solver(10, checkpoint_path=path, ncheckpoint=10)
    s.test_init()
    s.do_work()
    d = Solver2DDistributed(10, 10, 2, 2, 20, eps=3, k=1.0, dt=1e-4, dh=0.05,
                            mesh=make_mesh(2, 2, device_list(CPU, 4)))
    d.test_init()
    d.resume(path)
    d.do_work()
    full = _solver(20)
    full.test_init()
    full.do_work()
    assert np.max(np.abs(d.u - full.u)) <= 1e-12 * np.max(np.abs(full.u))


def test_distributed3d_checkpoint_resume_bit_identical(tmp_path):
    def make(nt, **kw):
        return Solver3DDistributed(8, 8, 8, nt, eps=2, k=0.5, dt=1e-4, dh=0.125,
                                   mesh=make_mesh_3d(2, 2, 2, device_list(CPU, 8)), **kw)

    path = str(tmp_path / "d3.npz")
    full, second = _interrupted(make, path, 12, 7, 5)
    assert np.array_equal(full.u, second.u)
    serial = Solver3D(8, 8, 8, 12, eps=2, k=0.5, dt=1e-4, dh=0.125, device=CPU)
    serial.test_init()
    serial.resume(path)
    serial.do_work()
    assert np.max(np.abs(serial.u - full.u)) <= 1e-12 * np.max(np.abs(full.u))


def _cloud(seed=0, m=12):
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    xs, ys = np.meshgrid(np.arange(m) * h, np.arange(m) * h, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    return pts, h


@pytest.mark.parametrize("layout", ["windowed", "offsets", "ell", "edges", "oracle"])
def test_unstructured_checkpoint_resume_bit_identical(tmp_path, layout):
    pts, h = _cloud()
    op = UnstructuredNonlocalOp(pts, 2.8 * h, k=0.5, dt=1e-5, vol=h * h, device=CPU)
    backend = "oracle" if layout == "oracle" else "torch"
    lay = "auto" if layout == "oracle" else layout

    def make(nt, **kw):
        return UnstructuredSolver(op, nt=nt, backend=backend, layout=lay, **kw)

    path = str(tmp_path / "cu.npz")
    full, second = _interrupted(make, path, 12, 7, 5)
    assert np.array_equal(full.u, second.u)
    # the checkpoint (the resumed run's, after step 10) holds the original
    # node order, whatever the layout
    saved, t, _ = ckpt.load_state(path)
    part = make(10)
    part.test_init()
    assert t == 10 and np.array_equal(saved, part.do_work())


def test_unstructured_checkpoint_param_mismatch_refuses(tmp_path):
    path = str(tmp_path / "cu2.npz")
    pts = np.random.default_rng(1).uniform(size=(64, 2))
    op = UnstructuredNonlocalOp(pts, 0.2, k=0.5, dt=1e-5, vol=1.0 / 64, device=CPU)
    s = UnstructuredSolver(op, nt=6, checkpoint_path=path, ncheckpoint=3)
    s.test_init()
    s.do_work()
    op2 = UnstructuredNonlocalOp(pts, 0.3, k=0.5, dt=1e-5, vol=1.0 / 64, device=CPU)
    other = UnstructuredSolver(op2, nt=6)
    other.test_init()
    with pytest.raises(ValueError, match="mismatch: eps"):
        other.resume(path)


def test_unstructured_checkpoint_crosses_the_packages(tmp_path):
    from nonlocalheatequation_tpu.ops.unstructured import (
        UnstructuredNonlocalOp as JaxOp,
    )
    from nonlocalheatequation_tpu.ops.unstructured import (
        UnstructuredSolver as JaxSolver,
    )

    pts, h = _cloud(seed=2, m=10)
    path = str(tmp_path / "x.npz")
    jax_s = JaxSolver(JaxOp(pts, 2.8 * h, k=0.5, dt=1e-5, vol=h * h), nt=9, backend="oracle",
                      checkpoint_path=path, ncheckpoint=4)
    jax_s.test_init()
    jax_s.do_work()
    ours = UnstructuredSolver(UnstructuredNonlocalOp(pts, 2.8 * h, k=0.5, dt=1e-5, vol=h * h,
                                                     device=CPU), nt=9, layout="windowed")
    ours.test_init()
    ours.resume(path)
    assert ours.t0 == 8
    ours.do_work()
    assert np.max(np.abs(ours.u - jax_s.u)) <= 1e-12 * np.max(np.abs(jax_s.u))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    kw = dict(eps=3, k=1.0, dt=1e-4, dh=0.05)
    full = JaxSolver2D(20, 20, 20, backend="jit", method="conv", dtype=jnp.float64, **kw)
    full.test_init()
    full.do_work()
    first = JaxSolver2D(20, 20, 20, backend="jit", method="conv", dtype=jnp.float64,
                        checkpoint_path=path, ncheckpoint=10, **kw)
    first.test_init()
    first.nt = 10
    first.do_work()
    ours = Solver2D(20, 20, 20, device=CPU, method="cuda", **kw)
    ours.test_init()
    ours.resume(path)
    assert ours.t0 == 10
    ours.do_work()
    ref = np.asarray(full.u)
    assert np.max(np.abs(ours.u - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    path = str(tmp_path / "port.npz")
    kw = dict(eps=3, k=1.0, dt=1e-4, dh=0.05)
    full = Solver2D(20, 20, 20, device=CPU, **kw)
    full.test_init()
    full.do_work()
    first = Solver2D(20, 20, 20, device=CPU, checkpoint_path=path, ncheckpoint=10, nd=4, **kw)
    first.test_init()
    first.nt = 10
    first.do_work()
    theirs = JaxSolver2D(20, 20, 20, backend="jit", method="conv", dtype=jnp.float64, **kw)
    theirs.test_init()
    theirs.resume(path)
    assert theirs.t0 == 10
    theirs.do_work()
    assert np.max(np.abs(np.asarray(theirs.u) - full.u)) <= 1e-12 * np.max(np.abs(full.u))


def test_cli_checkpoint_resume(tmp_path, capsys):
    path = str(tmp_path / "c.npz")
    base = ["--nx", "20", "--ny", "20", "--eps", "3", "--dt", "1e-4", "--dh", "0.05",
            "--test", "--cmp", "false", "--no-header", "--platform", "cpu"]
    assert solve2d.main(base + ["--nt", "10", "--checkpoint", path, "--ncheckpoint", "5"]) == 0
    assert solve2d.main(base + ["--nt", "20", "--checkpoint", path, "--resume"]) == 0
    out = capsys.readouterr().out
    resumed = float(out.split("l2: ")[-1].split()[0])
    full = _solver(20)
    full.test_init()
    full.do_work()
    assert resumed == pytest.approx(full.error_l2, rel=1e-5)


@pytest.mark.parametrize("argv,message", [
    (["--resume"], "--resume requires --checkpoint"),
    (["--test_batch", "--checkpoint", "c.npz"],
     "--checkpoint/--resume cannot be combined with --test_batch")])
@pytest.mark.parametrize("cli", [solve2d, solve3d, solve2d_distributed])
def test_cli_checkpoint_checks(capsys, cli, argv, message):
    assert cli.main(argv + ["--platform", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == message


def test_cli_3d_checkpoint_resume_serial_and_distributed(tmp_path, capsys):
    path = str(tmp_path / "c3.npz")
    base = ["--nx", "8", "--ny", "8", "--nz", "8", "--eps", "2", "--test", "--no-header",
            "--platform", "cpu"]
    assert solve3d.main(base + ["--nt", "6", "--checkpoint", path, "--ncheckpoint", "3",
                                "--distributed"]) == 0
    assert solve3d.main(base + ["--nt", "10", "--checkpoint", path, "--resume"]) == 0
    out = capsys.readouterr().out
    resumed = float(out.split("l2: ")[-1].split()[0])
    full = Solver3D(8, 8, 8, 10, 2, dh=0.0625, device=CPU)
    full.test_init()
    full.do_work()
    assert resumed == pytest.approx(full.error_l2, rel=1e-5)


def test_cli_distributed_checkpoint_resume(tmp_path, capsys):
    path = str(tmp_path / "d.npz")
    base = ["--nx", "10", "--ny", "10", "--npx", "2", "--npy", "2", "--eps", "3", "--dt",
            "1e-4", "--dh", "0.05", "--cmp", "false", "--no-header", "--platform", "cpu",
            "--devices", "4"]
    assert solve2d_distributed.main(base + ["--nt", "10", "--checkpoint", path,
                                            "--ncheckpoint", "5"]) == 0
    assert solve2d_distributed.main(base + ["--nt", "20", "--checkpoint", path,
                                            "--resume"]) == 0
    out = capsys.readouterr().out
    resumed = float(out.split("l2: ")[-1].split()[0])
    full = _solver(20)
    full.test_init()
    full.do_work()
    assert resumed == pytest.approx(full.error_l2, rel=1e-5)
