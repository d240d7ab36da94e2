"""Scaling constants, the Euler stability bound and the precision tiers.

The port's own copy of the parts of ``nonlocalheatequation_tpu/ops/constants.py``
that the forward-Euler path needs.  These reproduce the reference *code's*
constants, not the paper's:

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


def stable_dt(c: float, h: float, dim: int, wsum: float) -> float:
    """Largest stable forward-Euler dt.

    The operator's spectrum lies in [-2*c*h^d*Wsum, 0]; forward Euler
    (P(z) = 1 + z) is stable for z in [-2, 0], so dt <= 1/(c*h^d*Wsum).  A
    degenerate operator (c truncated to 0 by the 1D long cast) has an empty
    spectrum: every dt is stable (inf).
    """
    lam_max = 2.0 * c * (h ** dim) * wsum
    if lam_max <= 0.0:
        return math.inf
    return 2.0 / lam_max


def stable_dt_op(op) -> float:
    """:func:`stable_dt` with (c, h, dim, wsum) read off an operator."""
    dim = op.weights.ndim
    h = op.dx if dim == 1 else op.dh
    return stable_dt(op.c, h, dim, op.wsum)


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
