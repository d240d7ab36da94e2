"""Scaling constants, the steppers' stability bounds and the precision tiers.

The port's own copy of ``nonlocalheatequation_tpu/ops/constants.py``.  The
scaling constants reproduce the reference *code's* constants, not the
paper's:

* 1D: the reference stores ``(k * 3) / pow(eps * dx, 3)`` into a ``long``
  (src/1d_nonlocal_serial.cpp:57,74), so the constant is TRUNCATED to an
  integer (k=0.02, eps=40, dx=0.019 truncates to 0).
* 2D: ``c_2d = (k * 8) / pow(eps * dh, 4)`` kept as double
  (src/2d_nonlocal_serial.cpp:76).
* 3D: ``c_3d = (k * 15) / (2*pi*pow(eps * dh, 5))``, the JAX package's
  extension of the same recipe.
"""

import math

# A precision tier names the storage/operand precision of the neighbor-sum
# reads, never that of the accumulation or of the Euler carry:
#
# * "f32" (default): the state dtype end to end (float32 or float64).
# * "bf16": every operator evaluation reads the bfloat16 rounding of the
#   state, accumulates in the state dtype, and the carry u + dt*du stays in
#   the state dtype.  The center term Wsum*u uses the same rounded operand,
#   so L(const) == 0 holds exactly in the tier too.
PRECISION_TIERS = ("f32", "bf16")

# Manufactured-solution budget (error_l2/#points) of the bf16 tier at a
# stable timestep (0.8x the Euler bound); the f32 contract (1e-6) is not
# relaxed by it.  Same value as the reference package.
BF16_L2_BUDGET = 2e-6


def validate_precision(precision: str) -> str:
    """Validate a precision-tier name (see PRECISION_TIERS)."""
    if precision not in PRECISION_TIERS:
        raise ValueError(
            f"unknown precision tier {precision!r}; valid: {PRECISION_TIERS}"
        )
    return precision


# Autotuner gate for the precision dimension (utils/autotune.py,
# ``NLHEAT_TUNE_PRECISION=1``): a bf16 candidate may win a probe only if its
# multi-step output stays within this l2/#points of the f32 per-step program
# on the same probe state.  Same value as the reference package.
BF16_TUNE_GATE = 1e-5


# -- the time integrators' stability model ----------------------------------
#
# The operator's spectrum lies in [-2*c*h^d*Wsum, 0].  A one-step method with
# stability polynomial P is stable iff |P(dt*lambda)| <= 1 over it:
#
# * forward Euler, P(z) = 1 + z, stable on [-2, 0]: dt <= 1/(c*h^d*Wsum);
# * RKC (s-stage Runge-Kutta-Chebyshev, first order, damped),
#   P(z) = T_s(w0 + w1*z)/T_s(w0), stable on [-beta(s), 0] with
#   beta(s) = (1 + w0)/w1 ~ 2*s^2: dt <= beta(s)/(2*c*h^d*Wsum);
# * expo (spectral, method='fft' only): e^{dt*lambda} <= 1 for every dt.

#: Chebyshev damping for the RKC stepper: w0 = 1 + eta/s^2 keeps |P| strictly
#: below 1 inside the interval, at about 2.6% of its length.
RKC_DAMPING = 0.05


def _cheb_pair(s: int, w0: float) -> tuple:
    """(T_s(w0), T_s'(w0)) by the three-term recurrences."""
    t_prev, t = 1.0, w0  # T_0, T_1
    d_prev, d = 0.0, 1.0  # T_0', T_1'
    for _ in range(2, s + 1):
        t_prev, t = t, 2.0 * w0 * t - t_prev
        d_prev, d = d, 2.0 * t_prev + 2.0 * w0 * d - d_prev
    return (t, d) if s >= 1 else (1.0, 0.0)


def rkc_beta(stages: int) -> float:
    """Length beta(s) of the damped s-stage RKC polynomial's real stability
    interval [-(1 + w0)/w1, 0]: beta(2) ~ 7.7, beta(10) ~ 193."""
    s = int(stages)
    if s < 2:
        raise ValueError(f"RKC needs stages >= 2, got {stages}")
    w0 = 1.0 + RKC_DAMPING / (s * s)
    ts, dts = _cheb_pair(s, w0)
    w1 = ts / dts
    return (1.0 + w0) / w1


def stable_dt(c: float, h: float, dim: int, wsum: float, stepper: str = "euler",
              stages: int = 0) -> float:
    """Largest stable dt of the (stepper, stages) pair on an operator with
    scaling constant ``c``, spacing ``h``, dimension ``dim`` and weight sum
    ``wsum`` (the model above).  A degenerate operator (c truncated to 0 by
    the 1D long cast) has an empty spectrum: every dt is stable (inf)."""
    lam_max = 2.0 * c * (h ** dim) * wsum
    if stepper == "expo":
        return math.inf
    if lam_max <= 0.0:
        return math.inf
    if stepper == "euler":
        return 2.0 / lam_max
    if stepper == "rkc":
        return rkc_beta(stages) / lam_max
    raise ValueError(f"unknown stepper {stepper!r} (euler|rkc|expo)")


def stable_dt_op(op, stepper: str = "euler", stages: int = 0) -> float:
    """:func:`stable_dt` with (c, h, dim, wsum) read off an operator."""
    dim = op.weights.ndim
    h = op.dx if dim == 1 else op.dh
    return stable_dt(op.c, h, dim, op.wsum, stepper=stepper, stages=stages)


def c_1d(k: float, eps: int, dx: float) -> float:
    """1D scaling constant, integer-truncated exactly like the reference
    (src/1d_nonlocal_serial.cpp:74 stores the quotient into a ``long``)."""
    return float(int((k * 3) / math.pow(eps * dx, 3)))


def c_2d(k: float, eps: int, dh: float) -> float:
    """2D scaling constant (src/2d_nonlocal_serial.cpp:76), kept as double."""
    return (k * 8) / math.pow(eps * dh, 4)


def c_3d(k: float, eps: int, dh: float) -> float:
    """3D scaling constant (no 3D exists in the reference):
    c = 2k / integral_{|z|<eps*h} z_x^2 dz = 15k / (2*pi*(eps*h)^5), so the
    operator converges to k*laplace(u) as the horizon shrinks."""
    return (k * 15) / (2.0 * math.pi * math.pow(eps * dh, 5))
