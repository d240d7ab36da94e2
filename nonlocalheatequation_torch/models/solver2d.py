"""2D nonlocal heat solver — the NumPy oracle and the device path.

Counterpart of ``nonlocalheatequation_tpu/models/solver2d.py``:

* ``backend="oracle"`` — NumPy float64, the reference's serial loop
  (src/2d_nonlocal_serial.cpp:273-303), the ground truth.
* ``backend="torch"`` (default) — the time loop on ``device`` (the CUDA card
  unless ``device="cpu"``): one fused ``step2d`` kernel launch per step for
  ``method="cuda"``/``"auto"`` on the card, tensor ops otherwise.  In test
  mode the manufactured source's L(G) is evaluated on the device in float64
  by the operator's own method (the ``nsum2d`` kernel on the card).

Arrays are [x, y] of shape (nx, ny).  The dispatch-ahead throttle ``nd``
and checkpointing are not ported yet; the constructor refuses them.
:class:`GridSolver` holds the set-up and loop that ``Solver3D``
(models/solver3d.py) shares.
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.models.metrics import ManufacturedMetrics2D
from nonlocalheatequation_torch.models.steppers import (
    make_multi_step_fn,
    make_step_fn,
    validate_solver_stepper,
)
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, source_at
from nonlocalheatequation_torch.utils.devices import resolve_device, resolve_dtype

BACKENDS = ("oracle", "torch")


def refuse_unported(nd=None, checkpoint_path=None, ncheckpoint=0) -> None:
    if nd is not None:
        raise ValueError("nd (the dispatch-ahead throttle) is not ported yet")
    if checkpoint_path or ncheckpoint:
        raise ValueError("checkpointing is not ported yet (checkpoint_path/ncheckpoint)")


class GridSolver(ManufacturedMetrics2D):
    """The set-up and time loop the 2D and 3D solvers share: the NumPy
    oracle and the device path over ``self.op`` on ``self._grid_shape``."""

    def _setup(self, op, backend: str, stepper: str, stages: int, logger, dtype, device):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        self.op = op
        self.stepper, self.stages = validate_solver_stepper(op, backend, stepper, stages)
        self.backend = backend
        self.logger = logger
        self.t0 = 0
        self.test = False
        self.u0 = np.zeros(self._grid_shape, dtype=np.float64)
        self.u = None
        self.error_l2 = 0.0
        self.error_linf = 0.0

    # -- initialization (2d_nonlocal_serial.cpp:180-198) ----------------------
    def test_init(self):
        self.test = True
        self.u0 = self.op.spatial_profile(*self._grid_shape).copy()

    def input_init(self, values):
        self.test = False
        self.u0 = np.asarray(values, dtype=np.float64).reshape(self._grid_shape)

    # -- time loop (2d_nonlocal_serial.cpp:273-303) ---------------------------
    def do_work(self) -> np.ndarray:
        if self.backend == "oracle":
            u = self._run_oracle()
        else:
            u = self._run_torch()
        self.u = u
        if self.test:
            self.compute_l2(self.nt)
            self.compute_linf(self.nt)
        return u

    def _run_oracle(self):
        g, lg = self.op.source_parts(*self._grid_shape) if self.test else (None, None)
        u = self.u0.copy()
        for t in range(self.t0, self.nt):
            du = self.op.apply_np(u)
            if self.test:
                du = du + source_at(g, lg, t, self.op.dt)
            u = u + self.op.dt * du
            if t % self.nlog == 0 and self.logger is not None:
                self.logger(t, u)
        return u

    def _run_torch(self):
        g, lg = (self.op.source_parts_on(*self._grid_shape, self.device)
                 if self.test else (None, None))
        # a copy: the logged loop below steps into this buffer, and u0 (or the
        # caller's input_init array) must not change
        u = torch.tensor(self.u0, device=self.device, dtype=self.dtype)
        kw = dict(stepper=self.stepper, stages=self.stages)
        if self.logger is None:
            multi = make_multi_step_fn(self.op, self.nt - self.t0, g, lg, self.dtype, **kw)
            return multi(u, self.t0).cpu().numpy()
        step = make_step_fn(self.op, g, lg, self.dtype, **kw)
        spare = torch.empty_like(u)
        for t in range(self.t0, self.nt):
            nxt = step(u, t, out=spare)
            spare, u = u, nxt
            if t % self.nlog == 0:
                # a copy: the two step buffers are overwritten in turn
                self.logger(t, u.to("cpu", copy=True).numpy())
        return u.cpu().numpy()


class Solver2D(GridSolver):
    def __init__(
        self,
        nx: int,
        ny: int,
        nt: int,
        eps: int,
        nlog: int = 5,
        k: float = 1.0,
        dt: float = 0.0005,
        dh: float = 0.02,
        backend: str = "torch",
        method: str = "auto",
        stepper: str = "euler",
        stages: int = 0,
        nd: int | None = None,
        logger=None,
        dtype=None,
        checkpoint_path: str | None = None,
        ncheckpoint: int = 0,
        precision: str = "f32",
        resync_every: int = 0,
        device=None,
    ):
        refuse_unported(nd, checkpoint_path, ncheckpoint)
        self.nx, self.ny = int(nx), int(ny)
        self.nt, self.eps, self.nlog = int(nt), int(eps), int(nlog)
        op = NonlocalOp2D(eps, k, dt, dh, method=method, precision=precision,
                          resync_every=resync_every)
        self._setup(op, backend, stepper, stages, logger, dtype, device)

    @property
    def _grid_shape(self):
        return (self.nx, self.ny)
