"""The port's async binary (cli/solve2d_async.py) and the ``nd`` throttle of
its Solver2D, against the JAX package's, on the CPU.

* CASES_2D_ASYNC (the reference's async ctest table) through the port's
  ``solve2d_async --test_batch --platform cpu`` prints "Tests Passed", and
  each row through ``Solver2D(..., nd=5)`` meets error_l2/#points <= 1e-6.
* The throttle holds at most nd steps in flight and fills to nd
  (``max_inflight_ == nd``), as tests/test_async.py holds the JAX one.
* Throttled is bitwise unthrottled in the port (the throttle only paces the
  launches), and on two rows within 1e-12 (relative to the largest
  magnitude; float64, the sums in other orders) of the JAX
  ``Solver2D(backend="jit", nd=5)``.
* The timing line is the JAX printer's, character for character.
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.cli import solve2d_async
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.utils.timing import print_time_results_async
from nonlocalheatequation_tpu.models.solver2d import Solver2D as JaxSolver2D
from nonlocalheatequation_tpu.utils import timing as jax_timing
from tests.cases import CASES_2D_ASYNC, L2_THRESHOLD

torch.set_num_threads(1)
CPU = "cpu"


def _batch(rows) -> str:
    return f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)


def test_cli_batch_passes_over_cases_2d_async(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch(CASES_2D_ASYNC)))
    assert solve2d_async.main(["--test_batch", "--platform", "cpu", "--method", "cuda"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "Tests Passed"


@pytest.mark.parametrize("case", CASES_2D_ASYNC, ids=lambda c: "x".join(map(str, c[:4])))
def test_async_case_through_the_throttle(case):
    nx, ny, np_, nt, eps, k, dt, dh = case
    s = Solver2D(nx * np_, ny * np_, nt, eps, k=k, dt=dt, dh=dh, method="cuda", nd=5,
                 device=CPU)
    s.test_init()
    s.do_work()
    assert s.max_inflight_ == min(5, nt)
    assert s.error_l2 / (nx * ny * np_ * np_) <= L2_THRESHOLD


@pytest.mark.parametrize("nd", [1, 3])
def test_dispatch_throttle_bounds_inflight(nd):
    s = Solver2D(20, 20, 12, eps=3, k=0.2, dt=0.001, dh=0.02, method="cuda", nd=nd, device=CPU)
    s.test_init()
    s.do_work()
    assert s.max_inflight_ == nd


@pytest.mark.parametrize("method", ["cuda", "conv"])
def test_throttled_equals_unthrottled_bitwise(method):
    runs = []
    for nd in (None, 2, 5):
        s = Solver2D(20, 20, 10, eps=3, k=0.2, dt=0.001, dh=0.02, method=method, nd=nd,
                     device=CPU)
        s.input_init(np.random.default_rng(0).standard_normal(400))
        runs.append(s.do_work())
    assert np.array_equal(runs[0], runs[1]) and np.array_equal(runs[0], runs[2])


@pytest.mark.parametrize("row", [0, 1])
def test_throttled_matches_the_jax_throttled_solve(row):
    nx, ny, np_, nt, eps, k, dt, dh = CASES_2D_ASYNC[row]
    j = JaxSolver2D(nx * np_, ny * np_, nt, eps, k=k, dt=dt, dh=dh, backend="jit",
                    method="conv", nd=5, dtype=jnp.float64)
    j.test_init()
    j.do_work()
    t = Solver2D(nx * np_, ny * np_, nt, eps, k=k, dt=dt, dh=dh, method="cuda", nd=5,
                 device=CPU, dtype=torch.float64)
    t.test_init()
    t.do_work()
    ref = np.asarray(j.u)
    assert np.max(np.abs(t.u - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert t.max_inflight_ == j.max_inflight_ == 5


def test_single_solve_prints_the_async_timing_row(monkeypatch, capsys):
    assert solve2d_async.main(["--platform", "cpu", "--nx", "6", "--ny", "5", "--np", "2",
                               "--nt", "4", "--eps", "2", "--nd", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("2d_nonlocal_async (") and out[1].startswith("l2: ")
    assert out[2].startswith("OS_Threads,Execution_Time_sec")
    assert [f.strip() for f in out[3].split(",")][2:] == ["6", "5", "2", "4"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(" ".join(["1.0"] * 120)))
    assert solve2d_async.main(["--platform", "cpu", "--nx", "6", "--ny", "5", "--np", "2",
                               "--nt", "2", "--eps", "1", "--test", "false", "--no-header",
                               "--results"]) == 0
    out = capsys.readouterr().out
    assert "OS_Threads" not in out and "S[11][9] = " in out


def test_timing_row_matches_the_jax_package(capsys):
    for header in (True, False):
        print_time_results_async(8, 0.0123456789012345, 25, 25, 2, 45, header=header)
        ours = capsys.readouterr().out
        jax_timing.print_time_results_async(8, 0.0123456789012345, 25, 25, 2, 45,
                                            header=header)
        assert ours == capsys.readouterr().out


def test_default_platform_is_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform runs")
    assert solve2d_async.main(["--nt", "1"]) == 2
    assert "is_available() is false" in capsys.readouterr().err
