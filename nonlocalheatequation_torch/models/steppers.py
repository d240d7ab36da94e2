"""Time-stepper tier — the forward-Euler subset of
``nonlocalheatequation_tpu/models/steppers.py``.

``euler`` delegates to ops/nonlocal_op (make_step_fn / make_multi_step_fn,
including the fused ``step2d``/``step3d`` kernels), for the 1D, 2D and 3D
operators alike.  ``rkc`` and ``expo`` are not ported yet: they are refused
by name rather than silently run as Euler.
"""

from __future__ import annotations

from nonlocalheatequation_torch.ops.nonlocal_op import (
    make_multi_step_fn as _euler_multi_step_fn,
)
from nonlocalheatequation_torch.ops.nonlocal_op import (
    make_step_fn as _euler_step_fn,
)

STEPPERS = ("euler",)
_NOT_PORTED = ("rkc", "expo")


def validate_stepper(stepper: str, stages: int = 0) -> None:
    if stepper in _NOT_PORTED:
        raise ValueError(
            f"stepper={stepper!r} is not ported yet to nonlocalheatequation_torch; "
            "only 'euler' runs here (the JAX package has rkc and expo)")
    if stepper not in STEPPERS:
        raise ValueError(f"unknown stepper {stepper!r}; one of {STEPPERS}")
    if stages:
        raise ValueError("stepper='euler' takes no stage count")


def validate_solver_stepper(op, backend: str, stepper: str, stages: int) -> tuple:
    """Solver-construction validation for a 1D, 2D or 3D operator; returns
    the canonical (stepper, stages)."""
    validate_stepper(stepper, stages)
    return stepper, int(stages)


def make_step_fn(op, g=None, lg=None, dtype=None, stepper: str = "euler", stages: int = 0):
    validate_stepper(stepper, stages)
    return _euler_step_fn(op, g, lg, dtype)


def make_multi_step_fn(op, nsteps: int, g=None, lg=None, dtype=None,
                       stepper: str = "euler", stages: int = 0):
    validate_stepper(stepper, stages)
    return _euler_multi_step_fn(op, nsteps, g, lg, dtype)
