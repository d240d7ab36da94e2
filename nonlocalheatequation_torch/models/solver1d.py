"""1D nonlocal heat solver — the NumPy oracle and the device path.

Counterpart of ``nonlocalheatequation_tpu/models/solver1d.py``
(reference: src/1d_nonlocal_serial.cpp:32-236).  1D has no kernel: the
``torch`` backend runs the ``shift`` operator's slice-adds (or ``fft``, the
spectral apply) on ``device``, with the stepper ``stepper`` (euler, rkc or
expo; models/steppers.py).
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.models.metrics import ManufacturedMetrics2D
from nonlocalheatequation_torch.models.solver2d import BACKENDS, ensemble_case_of
from nonlocalheatequation_torch.models.steppers import (
    make_multi_step_fn,
    make_step_fn,
    validate_solver_stepper,
)
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp1D, source_at
from nonlocalheatequation_torch.utils.devices import resolve_device, resolve_dtype


class Solver1D(ManufacturedMetrics2D):
    """The manufactured-solution metrics are the rank-agnostic 2D ones
    (1d_nonlocal_serial.cpp:91-103 computes the same sums)."""

    def __init__(
        self,
        nx: int,
        nt: int,
        eps: int,
        nlog: int = 5,
        k: float = 1.0,
        dt: float = 0.001,
        dx: float = 0.02,
        backend: str = "torch",
        method: str = "shift",
        stepper: str = "euler",
        stages: int = 0,
        logger=None,
        dtype=None,
        precision: str = "f32",
        resync_every: int = 0,
        device=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        self.nx, self.nt, self.eps, self.nlog = int(nx), int(nt), int(eps), int(nlog)
        self.op = NonlocalOp1D(eps, k, dt, dx, method=method, precision=precision,
                               resync_every=resync_every)
        self.stepper, self.stages = validate_solver_stepper(self.op, backend, stepper, stages)
        self.backend = backend
        self.logger = logger
        self.t0 = 0
        self.test = False
        self.u0 = np.zeros(self.nx, dtype=np.float64)
        self.u = None
        self.error_l2 = 0.0
        self.error_linf = 0.0

    # -- initialization (1d_nonlocal_serial.cpp:116-129) ----------------------
    def test_init(self):
        self.test = True
        self.u0 = self.op.spatial_profile(self.nx).copy()

    def input_init(self, values):
        self.test = False
        self.u0 = np.asarray(values, dtype=np.float64).reshape(self.nx)

    def ensemble_case(self):
        """This solve as a serve/ensemble batch case (its ``dh`` field carries
        the 1D dx); see Solver2D.ensemble_case."""
        return ensemble_case_of(self, self._grid_shape, self.op.dx)

    # -- time loop (1d_nonlocal_serial.cpp:209-236) ---------------------------
    def do_work(self) -> np.ndarray:
        g, lg = self.op.source_parts(self.nx) if self.test else (None, None)
        if self.backend == "oracle":
            u = self.u0.copy()
            for t in range(self.t0, self.nt):
                du = self.op.apply_np(u)
                if self.test:
                    du = du + source_at(g, lg, t, self.op.dt)
                u = u + self.op.dt * du
                if t % self.nlog == 0 and self.logger is not None:
                    self.logger(t, u)
        else:
            u = torch.as_tensor(self.u0, device=self.device).to(self.dtype)
            kw = dict(stepper=self.stepper, stages=self.stages)
            if self.logger is None:
                u = make_multi_step_fn(self.op, self.nt - self.t0, g, lg, self.dtype,
                                       **kw)(u, self.t0)
            else:
                step = make_step_fn(self.op, g, lg, self.dtype, **kw)
                for t in range(self.t0, self.nt):
                    u = step(u, t)
                    if t % self.nlog == 0:
                        self.logger(t, u.cpu().numpy())
            u = u.cpu().numpy()
        self.u = u
        if self.test:
            self.compute_l2(self.nt)
            self.compute_linf(self.nt)
        return u

    @property
    def _grid_shape(self):
        return (self.nx,)
