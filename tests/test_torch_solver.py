"""The port's solvers against the JAX package's, and the reference contract.

* Solver2D on the CPU (float64) against the JAX ``Solver2D(backend="jit")``
  over three CASES_2D rows: final state within 1e-10 of the largest
  magnitude (the two add the stencil in different orders, over up to 200
  steps).
* Every CASES_2D and CASES_1D row meets error_l2/#points <= 1e-6 through
  the port; nt=0 gives an error of exactly 0.
* convert.py: JAX runs half the steps, the port runs the rest from the
  carried parameters and state, and ends where JAX's full run ends.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.convert import (
    solver1d_from_jax_state,
    solver2d_from_jax_state,
)
from nonlocalheatequation_torch.models.solver1d import Solver1D
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_tpu.models.solver1d import Solver1D as JaxSolver1D
from nonlocalheatequation_tpu.models.solver2d import Solver2D as JaxSolver2D
from tests.cases import CASES_1D, CASES_2D, L2_THRESHOLD

# small grids: one intra-op thread keeps parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("row,method", [(0, "auto"), (5, "auto"), (7, "cuda")])
def test_solver2d_matches_jax_jit(row, method):
    nx, ny, nt, eps, k, dt, dh = CASES_2D[row]
    j = JaxSolver2D(nx, ny, nt, eps, k=k, dt=dt, dh=dh, backend="jit", method="conv",
                    dtype=jnp.float64)
    j.test_init()
    j.do_work()
    t = Solver2D(nx, ny, nt, eps, k=k, dt=dt, dh=dh, method=method, device=CPU,
                 dtype=torch.float64)
    t.test_init()
    t.do_work()
    assert _rel(t.u, np.asarray(j.u)) <= 1e-10
    assert abs(t.error_l2 - j.error_l2) <= 1e-10 * max(j.error_l2, 1e-30) + 1e-20


@pytest.mark.parametrize("case", CASES_2D, ids=lambda c: "x".join(map(str, c[:4])))
def test_cases_2d_contract(case):
    nx, ny, nt, eps, k, dt, dh = case
    s = Solver2D(nx, ny, nt, eps, k=k, dt=dt, dh=dh, device=CPU)
    s.test_init()
    s.do_work()
    assert s.error_l2 / (nx * ny) <= L2_THRESHOLD


@pytest.mark.parametrize("case", CASES_1D, ids=lambda c: "x".join(map(str, c[:3])))
def test_cases_1d_contract(case):
    nx, nt, eps, k, dt, dx = case
    s = Solver1D(nx, nt, eps, k=k, dt=dt, dx=dx, device=CPU)
    s.test_init()
    s.do_work()
    assert s.error_l2 / nx <= L2_THRESHOLD


def test_nt_zero_is_exact_and_oracle_agrees():
    s = Solver2D(30, 30, 0, 5, device=CPU)
    s.test_init()
    s.do_work()
    assert s.error_l2 == 0.0 and s.error_linf == 0.0
    o = Solver2D(30, 24, 20, 5, backend="oracle", device=CPU)
    t = Solver2D(30, 24, 20, 5, method="shift", device=CPU)
    for s in (o, t):
        s.test_init()
        s.do_work()
    assert _rel(t.u, o.u) <= 1e-12
    one = Solver1D(40, 0, 5, device=CPU)
    one.test_init()
    one.do_work()
    assert one.error_l2 == 0.0


@pytest.mark.parametrize("method", ["auto", "cuda"])
def test_solver_logger_and_input_init(method):
    seen = []
    s = Solver2D(20, 20, 7, 3, nlog=3, method=method, device=CPU,
                 logger=lambda t, u: seen.append((t, u)))
    s.input_init(np.random.default_rng(0).standard_normal(400))
    u = s.do_work()
    ref = Solver2D(20, 20, 7, 3, method=method, device=CPU)
    ref.input_init(s.u0)
    one = Solver2D(20, 20, 1, 3, method=method, device=CPU)
    one.input_init(s.u0)
    assert [t for t, _ in seen] == [0, 3, 6]
    assert np.array_equal(u, ref.do_work()) and np.array_equal(seen[-1][1], u)
    # logged states are the caller's to keep: the step buffers do not reuse them
    assert np.array_equal(seen[0][1], one.do_work())


def test_solver_refusals():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            Solver2D(10, 10, 1, 2)
        with pytest.raises(RuntimeError, match="is_available"):
            Solver1D(10, 1, 2)
    # the stepper tier runs; what it refuses, it refuses in the JAX words
    s = Solver2D(10, 10, 1, 2, device=CPU, stepper="rkc", stages=4)
    assert (s.stepper, s.stages) == ("rkc", 4)
    with pytest.raises(ValueError, match="stepper='expo' integrates in the spectral domain"):
        Solver1D(10, 1, 2, device=CPU, stepper="expo")
    assert Solver1D(10, 1, 2, device=CPU, method="fft", stepper="expo").stepper == "expo"
    with pytest.raises(ValueError, match="torch.float64 or torch.float32"):
        Solver2D(10, 10, 1, 2, device=CPU, dtype=torch.float16)


def test_convert_2d_continues_a_jax_run():
    nx, ny, nt, eps, k, dt, dh = CASES_2D[4]
    half = nt // 2
    full = JaxSolver2D(nx, ny, nt, eps, k=k, dt=dt, dh=dh, backend="jit", method="conv",
                       dtype=jnp.float64)
    full.test_init()
    full.do_work()
    first = JaxSolver2D(nx, ny, half, eps, k=k, dt=dt, dh=dh, backend="jit", method="conv",
                        dtype=jnp.float64)
    first.test_init()
    first.do_work()
    s = solver2d_from_jax_state(first._ckpt_params(), np.asarray(first.u), half,
                                device=CPU, dtype=torch.float64, nt=nt)
    assert (s.t0, s.nt, s.test) == (half, nt, True)
    s.do_work()
    assert _rel(s.u, np.asarray(full.u)) <= 1e-10
    assert s.error_l2 / (nx * ny) <= L2_THRESHOLD
    with pytest.raises(ValueError, match="state shape"):
        solver2d_from_jax_state(first._ckpt_params(), np.zeros((3, 3)), half, device=CPU,
                                dtype=torch.float64)


def test_convert_1d_continues_a_jax_run():
    nx, nt, eps, k, dt, dx = CASES_1D[1]
    half = nt // 2
    runs = []
    for n in (nt, half):
        j = JaxSolver1D(nx, n, eps, k=k, dt=dt, dx=dx, backend="jit", dtype=jnp.float64)
        j.test_init()
        j.do_work()
        runs.append(np.asarray(j.u))
    params = dict(shape=[nx], eps=eps, k=k, dt=dt, dh=dx, test=True)
    s = solver1d_from_jax_state(params, runs[1], half, device=CPU, dtype=torch.float64, nt=nt)
    s.do_work()
    assert _rel(s.u, runs[0]) <= 1e-10
