"""Time-stepper tier — counterpart of ``nonlocalheatequation_tpu/models/steppers.py``.

The reference integrates with forward Euler (``u += dt * (L(u) + b)``,
src/2d_nonlocal_serial.cpp:281-283), so dt is capped at 1/(c*h^d*Wsum) and
the number of steps to a horizon, not the rate of a step, gates a long
solve.  The solvers (1D, 2D, 3D), the ensemble engine and the CLIs take
``stepper=euler|rkc|expo``:

* ``euler`` delegates to ops/nonlocal_op (``make_step_fn``,
  ``make_multi_step_fn``: the fused kernels and the tuner), unchanged.
* ``rkc``: s-stage Runge-Kutta-Chebyshev super-stepping (first order,
  damped; Verwer's RKC1 coefficients).  Its stability interval is
  beta(s) ~ 2*s^2 (ops/constants.rkc_beta), so dt may grow ~s^2/2 past the
  Euler bound at s operator applications a step.  Each stage is one
  ``op.apply``: on ``method="cuda"`` a pad and one ``nsum2d``/``nsum3d``
  launch, so rkc runs on the hand-written kernels with no kernel of its
  own.  The stage combination keeps the JAX package's expression order,
  ``mu*y1 + nu*y2 + (mut*dt)*rhs``, with the source frozen at the step's
  start.  A dt past the (stepper, stages) model (ops/constants.stable_dt)
  is refused at construction.
* ``expo``: exponential Euler (ETD1) in the spectral domain, ``method='fft'``
  only: ``u_hat <- e^{lambda*dt} u_hat + dt*phi1(lambda*dt) b_hat`` with the
  operator's exact circulant symbol (ops/spectral.operator_symbol).
  lambda <= 0, so it is unconditionally stable.  The collar (u = 0 outside
  the domain) is re-imposed at every step boundary; the circulant operator
  and the collar projection do not commute, so a step of size DT carries
  an O(DT^2) defect near the domain's edge.  ``stages = S >= 1`` arms the
  low-rank boundary correction: S substeps of dt/S, each adding the
  propagator-damped midpoint Duhamel term ``(sub/2) e^{L sub/2} D e^{L sub/2}``
  of the commutator ``D v = Pi L Pi v - L v`` (Pi the collar projection);
  ``stages=0`` is the plain step.  Its tables are computed in float64 on
  the host (``np.expm1``) and cast once per (shape, dtype, device).

The JAX package scans the step with ``lax.scan`` and donates the state
(utils/donation.py); here a Python loop steps it, and ``multi`` never
writes its input.  The NumPy ``oracle`` backend stays Euler-only (it is the
ground truth for the reference's own scheme): the solvers refuse
``backend='oracle'`` with another stepper.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.metrics import REGISTRY
from nonlocalheatequation_torch.ops import spectral
from nonlocalheatequation_torch.ops.constants import RKC_DAMPING, stable_dt_op
from nonlocalheatequation_torch.ops.nonlocal_op import (
    _Sources,
    check_bucket_ops,
    source_at,
)
from nonlocalheatequation_torch.ops.nonlocal_op import (
    make_multi_step_fn as _euler_multi_step_fn,
)
from nonlocalheatequation_torch.ops.nonlocal_op import (
    make_step_fn as _euler_step_fn,
)

STEPPERS = ("euler", "rkc", "expo")

#: The CLIs' rkc stage count when none is given: beta(8) ~ 124, dt up to
#: ~62x the Euler bound at 8 applications a step.
DEFAULT_STAGES = 8


def validate_stepper(op, stepper: str, stages: int = 0) -> None:
    """The stepper tier's checks, shared by the solvers, the ensemble engine
    and the CLIs; raises ValueError with the bound in force."""
    if stepper not in STEPPERS:
        raise ValueError(f"unknown stepper {stepper!r}; one of {STEPPERS}")
    if stepper == "euler":
        return
    if stepper == "rkc":
        if stages < 2:
            raise ValueError(
                f"stepper='rkc' needs stages >= 2 (got {stages}); "
                "stages ~ sqrt(2*dt/dt_euler) reaches a target dt")
        bound = stable_dt_op(op, "rkc", stages)
        if op.dt > bound * (1.0 + 1e-12):
            euler = stable_dt_op(op, "euler")
            raise ValueError(
                f"dt={op.dt:g} exceeds the {stages}-stage RKC stability "
                f"bound {bound:g} (Euler bound {euler:g}); raise "
                "--superstep-stages or shrink dt — integrating past the "
                "model would amplify, not diffuse")
        return
    if getattr(op, "method", None) != "fft":
        raise ValueError(
            "stepper='expo' integrates in the spectral domain; it "
            "requires method='fft' (the circulant symbol is the "
            "exponent) — rkc super-steps every other method")


def superstep_floor(op, horizon: float, stepper: str, stages: int = 0) -> int:
    """The fewest steps the (stepper, stages) model allows to ``horizon`` at
    0.8x its bound (expo: 1).  ``op``'s own dt is not read."""
    if stepper == "expo":
        return 1
    bound = 0.8 * stable_dt_op(op, stepper, stages)
    if not np.isfinite(bound):
        return 1
    return max(1, int(np.ceil(horizon / bound)))


def min_steps_to_target(trial, floor: int, cap: int, target: float, log=None) -> int:
    """Doubling from ``floor``, the fewest steps whose ``trial(nsteps) ->
    err_l2_per_n`` meets ``target``, else ``cap`` (the caller re-runs the
    count returned and records the error it gets)."""
    n = max(1, int(floor))
    while n <= cap:
        err = trial(n)
        if log is not None:
            log(n, err)
        if err <= target:
            return n
        n *= 2
    return cap


def validate_solver_stepper(op, backend: str, stepper: str, stages: int) -> tuple:
    """A solver's checks: :func:`validate_stepper`, and the oracle backend
    runs Euler only.  Returns the canonical (stepper, stages)."""
    validate_stepper(op, stepper, stages)
    if stepper != "euler" and backend == "oracle":
        raise ValueError(
            f"backend='oracle' is Euler-only (the reference's own "
            f"scheme); run stepper={stepper!r} on the torch backend")
    return stepper, int(stages)


def _rkc_coeffs(stages: int) -> dict:
    """Verwer's RKC1 coefficients as host floats.  With b_j = 1/T_j(w0),
    mu_j + nu_j = 1, so the stages need no separate y0 term and
    Y_j = T_j(w0 + w1*dt*L)/T_j(w0) u."""
    s = int(stages)
    w0 = 1.0 + RKC_DAMPING / (s * s)
    t = [1.0, w0]  # T_j(w0)
    d = [0.0, 1.0]  # T_j'(w0)
    for _ in range(2, s + 1):
        t.append(2.0 * w0 * t[-1] - t[-2])
        d.append(2.0 * t[-2] + 2.0 * w0 * d[-1] - d[-2])
    w1 = t[s] / d[s]
    b = [1.0 / tj for tj in t]
    mu = [0.0, 0.0]
    nu = [0.0, 0.0]
    mut = [0.0, w1 / w0]  # mu~_1 = b_1 * w1
    for j in range(2, s + 1):
        mu.append(2.0 * w0 * b[j] / b[j - 1])
        nu.append(-b[j] / b[j - 2])
        mut.append(2.0 * w1 * b[j] / b[j - 1])
    return {"s": s, "mu": mu, "nu": nu, "mut": mut}


def _make_rkc_step(op, g, lg, dtype, stages):
    """``step(u, t, out=None) -> u`` after one dt of the s-stage RKC1
    recurrence; each stage is one ``op.apply`` (``out`` is not used)."""
    co = _rkc_coeffs(stages)
    s, mu, nu, mut = co["s"], co["mu"], co["nu"], co["mut"]
    sources = _Sources(g, lg) if g is not None else None
    dt = op.dt

    def step(u, t, out=None):
        if dtype is not None and u.dtype != dtype:
            u = u.to(dtype)
        b = None
        if sources is not None:
            b = source_at(*sources.on(u), t, dt)

        def rhs(y):
            du = op.apply(y)
            return du if b is None else du + b

        y_prev2 = u
        y_prev = u + (mut[1] * dt) * rhs(u)
        for j in range(2, s + 1):
            y = mu[j] * y_prev + nu[j] * y_prev2 + (mut[j] * dt) * rhs(y_prev)
            y_prev2, y_prev = y_prev, y
        return y_prev

    return step


def _expo_tables(op, shape, dtype, device=None, sub_dt=None, correction=False) -> tuple:
    """The expo step's spectral tables, computed in float64 on the host
    (``np.expm1`` keeps phi1 = expm1(z)/z exact as z -> 0; the series covers
    the DC mode) and cast once to the real ``dtype`` on ``device``:
    ``(E, P)`` = (e^{lambda*dt}, dt*phi1(lambda*dt)) at the (sub)step, and
    with the correction ``Eh`` = e^{lambda*dt/2} and the symbol ``lam``."""
    lam = spectral.operator_symbol(op, shape)
    dt = op.dt if sub_dt is None else sub_dt
    z = lam * dt
    small = np.abs(z) < 1e-12
    z_safe = np.where(small, 1.0, z)
    phi1 = np.where(small, 1.0 + z / 2.0, np.expm1(z_safe) / z_safe)
    tables = [np.exp(z), dt * phi1]
    if correction:
        tables += [np.exp(0.5 * z), lam]
    return tuple(torch.as_tensor(a).to(device=device, dtype=dtype) for a in tables)


def _make_expo_step(op, g, lg, dtype, stages: int = 0):
    """``step(u, t, out=None) -> u`` after one dt of spectral ETD1; the
    zero-padding transform re-imposes the collar every step.  ``stages = S
    >= 1``: S corrected substeps of dt/S (module docstring)."""
    validate_stepper(op, "expo")
    sources = _Sources(g, lg) if g is not None else None
    dt = op.dt
    S = max(0, int(stages))
    tables: dict = {}

    def step(u, t, out=None):
        if dtype is not None and u.dtype != dtype:
            u = u.to(dtype)
        shape = tuple(u.shape)
        box = spectral.fft_box(shape, op.eps)
        dom = tuple(slice(0, n) for n in shape)
        key = (shape, u.dtype, u.device)
        if key not in tables:
            tables[key] = _expo_tables(op, shape, u.dtype, u.device, sub_dt=dt / max(1, S),
                                       correction=bool(S))

        def rfft(v):  # the transform of v's domain block, zero-padded to the box
            return torch.fft.rfftn(v[dom], s=box)

        def irfft(vh):
            return torch.fft.irfftn(vh, s=box)

        bh = None
        if sources is not None:
            bh = rfft(source_at(*sources.on(u), t, dt))
        uh = rfft(op._operand(u))
        if not S:
            E, P = tables[key]
            uh = E * uh
            if bh is not None:
                uh = uh + P * bh
            return irfft(uh)[dom]
        E, P, Eh, lam = tables[key]
        sub = dt / S

        def project(v):  # Pi: the collar re-zeroed (zero outside the domain block)
            z = torch.zeros_like(v)
            z[dom] = v[dom]
            return z

        cur_h = uh
        for i in range(S):
            mid_h = Eh * cur_h
            base_h = Eh * mid_h  # E * cur_h, through the damped midpoint
            if bh is not None:
                base_h = base_h + P * bh
            mid = irfft(mid_h)
            # D(mid) = Pi L Pi mid - L mid, supported on the eps boundary band
            d = project(irfft(lam * rfft(mid))) - irfft(lam * mid_h)
            cur_h = base_h + (0.5 * sub) * (Eh * torch.fft.rfftn(d))
            if i + 1 < S:
                # the collar re-zeroed between substeps, as at the step boundary
                cur_h = rfft(irfft(cur_h))
        return irfft(cur_h)[dom]

    return step


def make_step_fn(op, g=None, lg=None, dtype=None, stepper: str = "euler", stages: int = 0):
    """The stepper tier's ``step(u, t, out=None) -> u_next``; ``euler`` is
    ops/nonlocal_op.make_step_fn itself."""
    if stepper == "euler":
        return _euler_step_fn(op, g, lg, dtype)
    validate_stepper(op, stepper, stages)
    if stepper == "rkc":
        return _make_rkc_step(op, g, lg, dtype, stages)
    return _make_expo_step(op, g, lg, dtype, stages)


def _maybe_tune_method(op, g):
    """The stencil/fft crossover (``NLHEAT_TUNE_METHOD=1``, production
    solves only): a resolver ``(shape, dtype, device) -> op`` that times the
    op's own method against its fft twin once per key
    (utils/autotune.pick_op_method) and returns the faster.  The twin
    computes the same function within 1e-12, not bitwise, so the swap is
    opt-in, as ``NLHEAT_TUNE_PRECISION`` is."""
    if (os.environ.get("NLHEAT_TUNE_METHOD") != "1" or g is not None
            or getattr(op, "method", None) in (None, "fft")
            or not getattr(op, "uniform", True)):
        return None
    from nonlocalheatequation_torch.utils.autotune import pick_op_method

    memo: dict = {}

    def resolve(shape, dtype, device):
        key = (tuple(shape), dtype, torch.device(device))
        if key not in memo:
            memo[key] = pick_op_method(op, shape, dtype, device)
        return memo[key]

    return resolve


def _loop(step, nsteps: int, dtype):
    """``multi(u, t0)``: ``nsteps`` calls of ``step`` from ``u`` (a copy of
    it in ``dtype``; ``u`` is never written)."""
    def multi(u, t0):
        cur = u.to(dtype=dtype or u.dtype, copy=True)
        for t in range(t0, t0 + nsteps):
            cur = step(cur, t)
        return cur

    return multi


def make_multi_step_fn(op, nsteps: int, g=None, lg=None, dtype=None,
                       stepper: str = "euler", stages: int = 0):
    """``multi(u, t0) -> u`` after ``nsteps`` steps of the stepper.

    ``euler`` is ops/nonlocal_op.make_multi_step_fn (the kernel variants and
    the tuner, unchanged) unless ``NLHEAT_TUNE_METHOD=1`` swaps in the fft
    twin.  ``rkc``/``expo`` loop their step, set the ``/stepper/stages`` and
    ``/stepper/eff-dt`` gauges when built, make the loop on a key's first
    call in a ``solve.program`` span and run each call in a
    ``stepper.superstep`` span (obs/trace.py: free with no tracer and no
    profiler capture)."""
    tune = _maybe_tune_method(op, g)
    if stepper == "euler" and tune is None:
        return _euler_multi_step_fn(op, nsteps, g, lg, dtype)
    validate_stepper(op, stepper, stages)
    built: dict = {}

    def build(shape, dt_, device):
        op_run = op if tune is None else tune(shape, dt_, device)
        if stepper == "euler":
            return _euler_multi_step_fn(op_run, nsteps, g, lg, dtype)
        return _loop(make_step_fn(op_run, g, lg, dtype, stepper=stepper, stages=stages),
                     nsteps, dtype)

    REGISTRY.gauge("/stepper/stages").set(int(stages) if stepper == "rkc" else 1)
    REGISTRY.gauge("/stepper/eff-dt").set(float(op.dt))

    def multi_dispatch(u, t0):
        key = (tuple(u.shape), dtype or u.dtype, u.device)
        fn = built.get(key)
        if fn is None:
            with obs_trace.span("solve.program"):
                fn = built[key] = build(*key)
        with obs_trace.span("stepper.superstep", cat="stepper", stepper=stepper,
                            stages=stages, steps=nsteps, eff_dt=op.dt):
            return fn(u, t0)

    return multi_dispatch


def make_batched_multi_step_fn(ops, nsteps: int, dtype=None, test: bool = False, gs=None,
                               lgs=None, stepper: str = "rkc", stages: int = 0):
    """``multi(U, t0) -> U`` for a non-Euler ensemble bucket of ``(B,
    *shape)``: each case's solo stepper loop in turn, the results stacked
    (the stacked composition: lane b is bitwise the solo solve of case b).
    ``U`` is never written."""
    check_bucket_ops(ops)
    for op in ops:
        validate_stepper(op, stepper, stages)
    solos = [_loop(make_step_fn(op, gs[i] if test else None, lgs[i] if test else None,
                                dtype, stepper=stepper, stages=stages), nsteps, dtype)
             for i, op in enumerate(ops)]

    def multi(U, t0):
        return torch.stack([m(U[i], t0) for i, m in enumerate(solos)])

    return multi
