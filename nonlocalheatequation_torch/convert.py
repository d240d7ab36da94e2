"""Carry a solve's state from the JAX package into the port.

The system has no weights: what carries over is the operator's parameters
and the state.  ``params`` is exactly the dict that the JAX package's
``CheckpointMixin._ckpt_params()`` returns (``shape, eps, k, dt, dh, test``;
nonlocalheatequation_tpu/utils/checkpoint.py) and ``u`` the NumPy state at
integer step ``t``.  The returned solver is positioned at ``t0 = t``: its
``do_work()`` runs the steps ``t .. nt-1`` (``nt`` defaults to ``t``, i.e.
nothing left to run until the caller sets ``solver.nt``), with the
manufactured source on when ``params["test"]`` is set.

This module reads plain dicts and arrays; it imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np

from nonlocalheatequation_torch.models.solver1d import Solver1D
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D

_KEYS = ("shape", "eps", "k", "dt", "dh", "test")


def _checked(params: dict, u: np.ndarray, t: int, dim: int) -> np.ndarray:
    missing = [k for k in _KEYS if k not in params]
    if missing:
        raise ValueError(f"checkpoint params lack {missing} (expected {_KEYS})")
    shape = tuple(int(s) for s in params["shape"])
    if len(shape) != dim:
        raise ValueError(f"checkpoint shape {shape} is not {dim}D")
    u = np.asarray(u, dtype=np.float64)
    if u.shape != shape:
        raise ValueError(f"state shape {u.shape} != checkpoint shape {shape}")
    if int(t) < 0:
        raise ValueError(f"timestep must be >= 0, got {t}")
    return u


def _position(solver, params: dict, u: np.ndarray, t: int):
    solver.u0 = u.copy()
    solver.test = bool(params["test"])
    solver.t0 = int(t)
    return solver


def solver2d_from_jax_state(params: dict, u: np.ndarray, t: int, *, device, dtype,
                            nt: int | None = None, **solver_kwargs) -> Solver2D:
    """A port ``Solver2D`` carrying a JAX ``Solver2D``'s state at step ``t``.
    Extra keyword arguments (``method``, ``precision``, ...) go to the
    constructor."""
    u = _checked(params, u, t, 2)
    nx, ny = u.shape
    s = Solver2D(nx, ny, t if nt is None else nt, params["eps"], k=params["k"],
                 dt=params["dt"], dh=params["dh"], device=device, dtype=dtype,
                 **solver_kwargs)
    return _position(s, params, u, t)


def solver1d_from_jax_state(params: dict, u: np.ndarray, t: int, *, device, dtype,
                            nt: int | None = None, **solver_kwargs) -> Solver1D:
    """The 1D twin of :func:`solver2d_from_jax_state` (``dh`` carries dx)."""
    u = _checked(params, u, t, 1)
    s = Solver1D(u.shape[0], t if nt is None else nt, params["eps"], k=params["k"],
                 dt=params["dt"], dx=params["dh"], device=device, dtype=dtype,
                 **solver_kwargs)
    return _position(s, params, u, t)


def solver3d_from_jax_state(params: dict, u: np.ndarray, t: int, *, device, dtype,
                            nt: int | None = None, **solver_kwargs) -> Solver3D:
    """The 3D twin of :func:`solver2d_from_jax_state`: a port ``Solver3D``
    carrying a JAX ``Solver3D``'s state at step ``t``."""
    u = _checked(params, u, t, 3)
    nx, ny, nz = u.shape
    s = Solver3D(nx, ny, nz, t if nt is None else nt, params["eps"], k=params["k"],
                 dt=params["dt"], dh=params["dh"], device=device, dtype=dtype,
                 **solver_kwargs)
    return _position(s, params, u, t)
