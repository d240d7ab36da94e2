"""The port's 3D solve on the CPU against the JAX package's, in float64.

* Stencil and constant: ``horizon_mask_3d``, the sphere's column heights
  and ``c_3d`` equal the JAX package's for eps 1..20; the Euler bound reads
  dim=3 with h=dh; ``case_scale`` is ``c * dh**3`` in that form.
* Operator: every ``NonlocalOp3D`` method against the JAX
  ``neighbor_sum_np``/``apply_np`` to 1e-12 of the largest magnitude.
* Solver and CLI: ``Solver3D`` against the JAX ``Solver3D`` over CASES_3D
  (tests/test_oracle_3d.py) to 1e-10 (the two add the sphere in different
  orders over up to 40 steps), the rows' contract, and the CLI's "Tests
  Passed" with ``--platform cpu``.
* The tuner's 3D branch, convert.solver3d_from_jax_state, the 3D timing
  row, chip_smoke.py's copy of CASES_3D, and the build digest's scope.
"""

import importlib.util
import io
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.cli import solve3d
from nonlocalheatequation_torch.convert import solver3d_from_jax_state
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.ops import _build
from nonlocalheatequation_torch.ops import constants as TC
from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
from nonlocalheatequation_torch.ops import stencil as TS
from nonlocalheatequation_torch.ops.nonlocal_op import (
    NonlocalOp3D,
    case_scale,
    make_multi_step_fn,
    make_multi_step_fn_base,
)
from nonlocalheatequation_torch.utils import autotune
from nonlocalheatequation_torch.utils.timing import print_time_results_3d
from nonlocalheatequation_tpu.models.solver3d import Solver3D as JaxSolver3D
from nonlocalheatequation_tpu.ops import constants as JC
from nonlocalheatequation_tpu.ops import stencil as JS
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp3D as JaxOp3D
from nonlocalheatequation_tpu.utils import timing as jax_timing
from tests.cases import L2_THRESHOLD
from tests.test_oracle_3d import CASES_3D

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _batch(rows) -> str:
    return f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)


# -- stencil and constant -------------------------------------------------------

@pytest.mark.parametrize("eps", range(1, 21))
def test_sphere_heights_and_constant_match(eps):
    assert np.array_equal(TS.horizon_mask_3d(eps), JS.horizon_mask_3d(eps))
    assert np.array_equal(TS.sphere_column_heights(eps), JaxOp3D(eps, 1.0, 1e-4, 0.1)._zh)
    for k, dh in ((1.0, 0.0625), (0.5, 0.05), (0.02, 1.0 / 256), (1.0, 1.0 / 12)):
        assert TC.c_3d(k, eps, dh) == JC.c_3d(k, eps, dh)
        top, jop = NonlocalOp3D(eps, k, 1e-4, dh), JaxOp3D(eps, k, 1e-4, dh)
        assert TC.stable_dt_op(top) == JC.stable_dt_op(jop)
        assert TC.stable_dt_op(top) == 2.0 / (2.0 * top.c * dh**3 * top.wsum)


def test_sphere_point_and_column_counts():
    for eps, points, columns, heights in ((4, 257, 49, 5), (6, 925, 113, 7)):
        zh = TS.sphere_column_heights(eps)
        assert int(TS.horizon_mask_3d(eps).sum()) == points
        assert int((zh >= 0).sum()) == columns
        assert len(set(zh[zh >= 0].tolist())) == heights


def test_case_scale_is_c_times_dh_cubed_in_that_form():
    differs = []
    for n in range(3, 400):
        op = NonlocalOp3D(3, 1.0, 1e-4, 1.0 / n)
        assert case_scale(op) == op.c * op.dh**3
        if op.c * op.dh**3 != op.c * op.dh * op.dh * op.dh:
            differs.append(n)
    # dh*dh*dh rounds twice: for these spacings it gives other bits, which a
    # case_scale written that way would fail above
    assert differs


# -- operator -------------------------------------------------------------------

@pytest.mark.parametrize("method", ["shift", "sat", "cuda", "auto"])
@pytest.mark.parametrize("shape,eps", [((10, 12, 14), 3), ((6, 6, 6), 8), ((9, 5, 7), 2)])
def test_operator_methods_match_jax(method, shape, eps):
    u = np.random.default_rng(sum(shape) + eps).standard_normal(shape)
    jop = JaxOp3D(eps, 1.0, 1e-4, 0.05, method="shift")
    top = NonlocalOp3D(eps, 1.0, 1e-4, 0.05, method=method)
    ref_sum, ref_l = jop.neighbor_sum_np(u), jop.apply_np(u)
    assert np.array_equal(top.neighbor_sum_np(u), ref_sum)
    assert np.array_equal(top.apply_np(u), ref_l)
    x = torch.from_numpy(u)
    assert _rel(top.neighbor_sum(x).numpy(), ref_sum) <= 1e-12
    assert _rel(top.apply(x).numpy(), ref_l) <= 1e-12
    upad = torch.nn.functional.pad(x, (eps,) * 6)
    assert _rel(top.apply_padded(upad).numpy(), ref_l) <= 1e-12
    assert top.resolve_method(CPU) == ("sat" if method == "auto" else method)


def test_operator_twins_weights_and_sources():
    op = NonlocalOp3D(3, 0.5, 1e-4, 0.05, method="cuda", precision="bf16", resync_every=2)
    twin = op.with_precision("f32")
    assert (twin.method, twin.precision, twin.resync_every) == ("cuda", "f32", 0)
    jop = JaxOp3D(3, 0.5, 1e-4, 0.05)
    g, lg = op.source_parts(8, 7, 6)
    jg, jlg = jop.source_parts(8, 7, 6)
    assert np.array_equal(g, jg) and np.array_equal(lg, jlg)
    tg, tlg = op.source_parts_on(8, 7, 6, CPU)
    assert torch.equal(tg, torch.from_numpy(g)) and _rel(tlg.numpy(), lg) <= 1e-12
    assert np.array_equal(op.manufactured_solution(8, 7, 6, 5),
                          jop.manufactured_solution(8, 7, 6, 5))
    # a weighted influence function demotes sat/cuda/auto to shift, as in JAX
    J = lambda r: math.exp(-r)  # noqa: E731
    for m in ("sat", "cuda", "auto"):
        w = NonlocalOp3D(2, 1.0, 1e-4, 0.05, influence=J, method=m)
        assert w.method == JaxOp3D(2, 1.0, 1e-4, 0.05, influence=J, method="sat").method
        assert w.method == "shift"
    u = np.random.default_rng(1).standard_normal((7, 6, 5))
    jw = JaxOp3D(2, 1.0, 1e-4, 0.05, influence=J, method="shift")
    assert _rel(w.apply(torch.from_numpy(u)).numpy(), jw.apply_np(u)) <= 1e-12
    # fft bakes the weights into its symbol: a weighted J keeps it
    wf = NonlocalOp3D(2, 1.0, 1e-4, 0.05, influence=J, method="fft")
    assert wf.method == "fft"
    assert _rel(wf.apply(torch.from_numpy(u)).numpy(), jw.apply_np(u)) <= 1e-12


def test_bf16_operator_matches_jax():
    u = np.random.default_rng(2).standard_normal((9, 8, 7)).astype(np.float32)
    jop = JaxOp3D(3, 1.0, 1e-4, 0.05, method="shift", precision="bf16")
    top = NonlocalOp3D(3, 1.0, 1e-4, 0.05, method="shift", precision="bf16")
    assert _rel(top.apply(torch.from_numpy(u)).numpy(), jop.apply(jnp.asarray(u))) <= 1e-5


# -- solver and CLI ---------------------------------------------------------------

@pytest.mark.parametrize("case", CASES_3D, ids=lambda c: "x".join(map(str, c[:5])))
def test_solver3d_matches_jax_over_cases_3d(case):
    nx, ny, nz, nt, eps, k, dt, dh = case
    j = JaxSolver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, backend="jit", method="sat",
                    dtype=jnp.float64)
    j.test_init()
    j.do_work()
    t = Solver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, device=CPU, dtype=torch.float64)
    t.test_init()
    t.do_work()
    assert _rel(t.u, np.asarray(j.u)) <= 1e-10
    assert abs(t.error_l2 - j.error_l2) <= 1e-10 * max(j.error_l2, 1e-30) + 1e-20
    assert t.error_l2 / (nx * ny * nz) <= L2_THRESHOLD


@pytest.mark.parametrize("method", ["shift", "cuda"])
def test_solver3d_methods_and_oracle_agree(method):
    nx, ny, nz, nt, eps, k, dt, dh = CASES_3D[2]
    o = Solver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, backend="oracle", device=CPU)
    t = Solver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, method=method, device=CPU,
                 dtype=torch.float64)
    for s in (o, t):
        s.test_init()
        s.do_work()
    assert _rel(t.u, o.u) <= 1e-12
    zero = Solver3D(nx, ny, nz, 0, eps, k=k, dt=dt, dh=dh, device=CPU)
    zero.test_init()
    zero.do_work()
    assert zero.error_l2 == 0.0 and zero.error_linf == 0.0


def test_solver3d_logger_input_init_and_refusals():
    seen = []
    s = Solver3D(8, 7, 6, 7, 2, nlog=3, method="cuda", device=CPU,
                 logger=lambda t, u: seen.append((t, u)))
    s.input_init(np.random.default_rng(0).standard_normal(8 * 7 * 6))
    u = s.do_work()
    ref = Solver3D(8, 7, 6, 7, 2, method="cuda", device=CPU)
    ref.input_init(s.u0)
    assert [t for t, _ in seen] == [0, 3, 6]
    assert np.array_equal(u, ref.do_work()) and np.array_equal(seen[-1][1], u)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            Solver3D(4, 4, 4, 1, 1)
    assert Solver3D(4, 4, 4, 1, 1, device=CPU, stepper="rkc", stages=4).stages == 4
    with pytest.raises(ValueError, match="requires method='fft'"):
        Solver3D(4, 4, 4, 1, 1, device=CPU, stepper="expo")
    # the dispatch-ahead throttle is Solver2D's; the JAX Solver3D has no nd
    with pytest.raises(ValueError, match="Solver3D takes no nd"):
        Solver3D(4, 4, 4, 1, 1, device=CPU, nd=4)
    case = Solver3D(4, 4, 4, 1, 1, device=CPU).ensemble_case()
    assert case.shape == (4, 4, 4) and case.bucket_key() == ((4, 4, 4), 1, 1, False, None)
    s = Solver3D(4, 4, 4, 3, 1, device=CPU)
    s.t0 = 1
    with pytest.raises(ValueError, match="starts every case at t0=0"):
        s.ensemble_case()


@pytest.mark.parametrize("x64", ["1", "0"])
def test_cli_batch_passes_over_cases_3d(monkeypatch, capsys, x64):
    rows = CASES_3D if x64 == "1" else CASES_3D[:2]
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch(rows)))
    assert solve3d.main(["--test_batch", "--platform", "cpu", "--x64", x64]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "Tests Passed"


def test_cli_single_solve_timing_row_and_failure(monkeypatch, capsys):
    assert solve3d.main(["--test", "--platform", "cpu", "--nx", "8", "--ny", "7", "--nz", "6",
                         "--nt", "4", "--eps", "2", "--method", "cuda"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("l2: ") and "z dimension" in out[2]
    assert [f.strip() for f in out[3].split(",")][2:] == ["8", "7", "6", "4"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(" ".join(["1.0"] * 27)))
    assert solve3d.main(["--platform", "cpu", "--nx", "3", "--ny", "3", "--nz", "3", "--nt",
                         "2", "--eps", "1", "--no-header", "--backend", "oracle"]) == 0
    assert "x dimension" not in capsys.readouterr().out
    # a diverging row (dt far past the Euler bound) fails the contract
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch([(8, 8, 8, 40, 2, 1.0, 0.5, 0.1)])))
    assert solve3d.main(["--test_batch", "--platform", "cpu"]) == 1
    assert "Tests Failed" in capsys.readouterr().out


@pytest.mark.parametrize("argv,name", [
    (["--ncheckpoint", "3"], None), (["--listen-host=h"], "--listen-host"),
    (["--serve-deadline-ms=5"], None), (["--checkpoint", "x.npz"], None),
    (["--resume"], None), (["--serve", "2"], None),
    (["--serve-retries=1"], None), (["--listen", "0"], "--listen"),
    (["--profile", "d"], None), (["--method", "fft"], None)])
def test_cli_refuses_what_is_not_ported_by_name(capsys, tmp_path, monkeypatch, argv, name):
    if name == "--listen-host":
        # no such flag in either package: argparse's unrecognized-argument
        # exit (rc 2), as the JAX CLI gives
        with pytest.raises(SystemExit) as e:
            solve3d.main(argv + ["--platform", "cpu"])
        assert e.value.code == 2
        assert "unrecognized arguments: --listen-host=h" in capsys.readouterr().err
        return
    if name == "--listen":
        # ported since: accepted and validated as the JAX CLI validates it
        assert solve3d.main(argv + ["--test", "--platform", "cpu"]) == 1
        assert capsys.readouterr().err.strip() == (
            "--listen serves cases over HTTP; --test belongs to the stdin-driven modes — "
            "drop one of them")
        assert solve3d.main(argv + ["--distributed", "--platform", "cpu"]) == 1
        assert capsys.readouterr().err.strip() == (
            "--listen runs the serial batched engine; it cannot be combined with "
            "--distributed")
        assert solve3d.main(argv + ["--shard-threshold", "64", "--platform", "cpu"]) == 1
        assert "use solve2d" in capsys.readouterr().err
        return
    # ported since: the flag runs a single solve (rc 0) and writes its file;
    # --serve on a single solve gets the JAX refusal, and the supervision
    # flags alone are accepted (they wait for --serve)
    monkeypatch.chdir(tmp_path)
    base = ["--test", "--platform", "cpu", "--nx", "6", "--ny", "5", "--nz", "4", "--nt", "4",
            "--eps", "1"]
    if argv == ["--serve", "2"]:
        assert solve3d.main(base + argv) == 1
        assert capsys.readouterr().err.strip() == \
            "--serve streams batch-test cases; it requires --test_batch"
        return
    if argv[0].startswith("--serve-"):
        assert solve3d.main(base + argv) == 0
        assert "l2: " in capsys.readouterr().out
        assert not list(tmp_path.iterdir())  # a solve, no file
        return
    if argv == ["--resume"]:
        assert solve3d.main(base + ["--checkpoint", "x.npz", "--ncheckpoint", "2"]) == 0
        argv = ["--checkpoint", "x.npz", "--resume", "--nt", "6"]
    elif argv[0] == "--ncheckpoint":
        argv = argv + ["--checkpoint", "x.npz", "--nt", "6"]
    elif argv[0] == "--checkpoint":
        argv = argv + ["--ncheckpoint", "2"]
    assert solve3d.main(base + argv) == 0
    assert "l2: " in capsys.readouterr().out
    if "--profile" in argv:
        assert len(list((tmp_path / "d").iterdir())) == 1
    elif argv == ["--method", "fft"]:
        assert not list(tmp_path.iterdir())  # a solve, no file
    else:
        from nonlocalheatequation_torch.utils.checkpoint import load_state

        _, t, params = load_state(str(tmp_path / "x.npz"))
        assert params["shape"] == [6, 5, 4] and t == (6 if argv[:2] == ["--ncheckpoint", "3"]
                                                      else 4)


def test_cli_module_entry_point():
    r = subprocess.run([sys.executable, "-m", "nonlocalheatequation_torch.cli.solve3d",
                        "--test_batch", "--platform", "cpu"], input=_batch([CASES_3D[3]]),
                       capture_output=True, text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "Tests Passed"


def test_timing_row_matches_the_jax_package(capsys):
    for header in (True, False):
        print_time_results_3d(8, 0.0123456789012345, 16, 12, 8, 20, header=header)
        ours = capsys.readouterr().out
        jax_timing.print_time_results_3d(8, 0.0123456789012345, 16, 12, 8, 20, header=header)
        assert ours == capsys.readouterr().out


def test_chip_smokes_copy_of_cases_3d():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                            "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.CASES_3D == CASES_3D


# -- tuner, convert, build digest --------------------------------------------------

def test_tuner_3d_candidates_and_pick(monkeypatch):
    monkeypatch.setattr(autotune, "_memory_cache", {})
    op = NonlocalOp3D(3, 1.0, 1e-6, 1.0 / 12, method="cuda")
    names = lambda o, **kw: [n for n, _m in autotune.candidates(  # noqa: E731
        o, (12, 10, 9), 6, torch.float64, CPU)]
    assert names(op) == ["per-step", "carried3d", "resident3d"]
    assert names(NonlocalOp3D(3, 1.0, 1e-6, 1.0 / 12, method="cuda", precision="bf16")) == [
        "per-step"]
    monkeypatch.setattr(k3, "fits_resident_3d", lambda *a, **kw: False)
    assert names(op) == ["per-step", "carried3d"]
    monkeypatch.undo()
    monkeypatch.setattr(autotune, "_memory_cache", {})
    u = torch.from_numpy(np.random.default_rng(3).standard_normal((12, 10, 9)))
    ref = make_multi_step_fn_base(op, 5)(u, 0)
    fn, winner = autotune.pick_multi_step_fn(op, 5, (12, 10, 9), torch.float64, CPU)
    assert torch.equal(fn(u, 0), ref)
    (key, entry), = autotune.records().items()
    assert key == f"k{autotune.kernels_digest(3)}/cpu/cuda/12x10x9/eps3/float64"
    assert set(entry["ms_per_step"]) == {"per-step", "carried3d", "resident3d"}
    assert entry["winner"] == winner
    for name, maker in autotune.candidates(op, (12, 10, 9), 5, torch.float64, CPU):
        assert torch.equal(maker(op, 5, torch.float64)(u, 0), ref), name
    # a CPU tensor runs the per-step loop, untuned
    monkeypatch.setattr(autotune, "_memory_cache", {})
    assert torch.equal(make_multi_step_fn(op, 5)(u, 0), ref) and autotune.records() == {}


def test_convert_3d_continues_a_jax_run():
    nx, ny, nz, nt, eps, k, dt, dh = CASES_3D[0]
    half = nt // 2
    runs = []
    for n in (nt, half):
        j = JaxSolver3D(nx, ny, nz, n, eps, k=k, dt=dt, dh=dh, backend="jit", method="sat",
                        dtype=jnp.float64)
        j.test_init()
        j.do_work()
        runs.append(j)
    full, first = runs
    s = solver3d_from_jax_state(first._ckpt_params(), np.asarray(first.u), half, device=CPU,
                                dtype=torch.float64, nt=nt)
    assert (s.t0, s.nt, s.test) == (half, nt, True)
    s.do_work()
    assert _rel(s.u, np.asarray(full.u)) <= 1e-12
    assert s.error_l2 / (nx * ny * nz) <= L2_THRESHOLD
    with pytest.raises(ValueError, match="is not 3D"):
        solver3d_from_jax_state(dict(first._ckpt_params(), shape=[4, 4]), np.zeros((4, 4)), 0,
                                device=CPU, dtype=torch.float64)


def test_build_digest_hashes_only_the_included_headers(monkeypatch, tmp_path):
    assert _build.included_headers("nsum2d.cu") == ["stencil_tile.cuh"]
    for source in _build.SOURCES_3D:
        assert _build.included_headers(source) == ["stencil_tile.cuh", "stencil_tile3d.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {s: _build.source_digest(s) for s in _build.SOURCES}
    tuned = {d: autotune.kernels_digest(d) for d in (2, 3)}
    with open(csrc / "stencil_tile3d.cuh", "a") as f:
        f.write("\n// changed\n")
    after = {s: _build.source_digest(s) for s in _build.SOURCES}
    # a 3D header change rebuilds the 3D libraries and starts new 3D records only
    assert all(after[s] == before[s] for s in _build.SOURCES_2D)
    assert all(after[s] != before[s] for s in _build.SOURCES_3D)
    assert autotune.kernels_digest(2) == tuned[2] and autotune.kernels_digest(3) != tuned[3]
    with open(csrc / "stencil_tile.cuh", "a") as f:
        f.write("\n// changed\n")
    assert all(_build.source_digest(s) != after[s] for s in _build.SOURCES)
