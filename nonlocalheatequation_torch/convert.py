"""Carry a solve's state from the JAX package into the port.

The system has no weights: what carries over is the operator's parameters
and the state.  ``params`` is exactly the dict that the JAX package's
``CheckpointMixin._ckpt_params()`` returns (``shape, eps, k, dt, dh, test``;
nonlocalheatequation_tpu/utils/checkpoint.py) and ``u`` the NumPy state at
integer step ``t``.  The returned solver is positioned at ``t0 = t``: its
``do_work()`` runs the steps ``t .. nt-1`` (``nt`` defaults to ``t``, i.e.
nothing left to run until the caller sets ``solver.nt``), with the
manufactured source on when ``params["test"]`` is set.

:func:`ensemble_case_from_jax` carries one case of the JAX package's
ensemble engine (its ``EnsembleCase``) into the port's, so both engines run
the same buckets, mesh buckets included.  :func:`unstructured_op_from_jax`
and :func:`unstructured_solver_from_jax_state` carry an unstructured
operator and a solve's state.

This module reads plain dicts, arrays and attributes; it imports nothing of
JAX.
"""

from __future__ import annotations

import numpy as np

from nonlocalheatequation_torch.models.solver1d import Solver1D
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp, UnstructuredSolver
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase

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


def ensemble_case_from_jax(case) -> EnsembleCase:
    """The port's EnsembleCase for a JAX ``EnsembleCase`` (any object with its
    fields): the same shape, step count, eps, physics, test flag and mesh
    hash (a mesh case resolves through the shared ``.npz`` mesh store,
    serve/meshes.py), and its ``u0`` as a float64 NumPy array."""
    u0 = None if case.u0 is None else np.array(case.u0, dtype=np.float64)
    mesh = getattr(case, "mesh", None)
    return EnsembleCase(shape=tuple(int(s) for s in case.shape), nt=int(case.nt),
                        eps=int(case.eps), k=float(case.k), dt=float(case.dt),
                        dh=float(case.dh), test=bool(case.test), u0=u0,
                        mesh=None if mesh is None else str(mesh))


def unstructured_op_from_jax(op, *, device) -> UnstructuredNonlocalOp:
    """The port's operator for a JAX ``UnstructuredNonlocalOp`` (any object
    with its fields), built from its points, horizon field, volumes, k and
    dt as NumPy arrays; refuses unless the edge table, ``c`` and ``wsum``
    come out equal to the JAX operator's (an influence function or a given
    ``c`` is not carried: the JAX operator keeps neither)."""
    new = UnstructuredNonlocalOp(np.asarray(op.points), np.asarray(op.eps), k=float(op.k),
                                 dt=float(op.dt), vol=np.asarray(op.vol), device=device)
    for name in ("tgt", "src", "c", "wsum"):
        if not np.array_equal(getattr(new, name), np.asarray(getattr(op, name))):
            raise ValueError(f"unstructured_op_from_jax: {name} differs from the JAX "
                             "operator's (an influence function or a given c is not carried)")
    return new


def unstructured_solver_from_jax_state(op, u: np.ndarray, t: int, *, device, dtype=None,
                                       test: bool = False, nt: int | None = None,
                                       **solver_kwargs) -> UnstructuredSolver:
    """A port ``UnstructuredSolver`` carrying a JAX unstructured solve's
    state ``u`` (n,) at step ``t`` over :func:`unstructured_op_from_jax` of
    its operator ``op``: ``do_work()`` runs the steps ``t .. nt-1`` (``nt``
    defaults to ``t``), with the manufactured source when ``test``."""
    u = np.asarray(u, dtype=np.float64)
    if u.shape != (int(op.n),):
        raise ValueError(f"state shape {u.shape} != ({int(op.n)},)")
    if int(t) < 0:
        raise ValueError(f"timestep must be >= 0, got {t}")
    s = UnstructuredSolver(unstructured_op_from_jax(op, device=device),
                           t if nt is None else nt, dtype=dtype, **solver_kwargs)
    s.u0 = u.copy()
    s.test = bool(test)
    s.t0 = int(t)
    return s
