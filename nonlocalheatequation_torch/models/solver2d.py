"""2D nonlocal heat solver — the NumPy oracle and the device path.

Counterpart of ``nonlocalheatequation_tpu/models/solver2d.py``:

* ``backend="oracle"`` — NumPy float64, the reference's serial loop
  (src/2d_nonlocal_serial.cpp:273-303), the ground truth.
* ``backend="torch"`` (default) — the time loop on ``device`` (the CUDA card
  unless ``device="cpu"``): one fused ``step2d`` kernel launch per step for
  ``method="cuda"``/``"auto"`` on the card, tensor ops otherwise.  In test
  mode the manufactured source's L(G) is evaluated on the device in float64
  by the operator's own method (the ``nsum2d`` kernel on the card).

The device path has three forms, as the JAX package's ``_run_jit``:

* no logger, no checkpoints and ``nd=None``: one multi-step program over
  the whole run (``make_multi_step_fn``, tuned on the card);
* a logger or checkpoints: one multi-step program per segment between the
  barriers (every ``nlog`` steps, every ``ncheckpoint`` steps;
  utils/checkpoint.CheckpointMixin._run_chunked);
* ``nd`` set: the async binary's sliding semaphore
  (src/2d_nonlocal_async.cpp:410,442-451), one ``make_step_fn`` step at a
  time with at most ``nd`` steps in flight on the card: a CUDA event is
  recorded after each step and the oldest is waited on once more than
  ``nd`` are outstanding.

Every device form runs in the same three steps around its loop, each in an
obs/trace.py span (with ``--profile DIR`` a ``nlheat.solve.*`` range in the
capture): ``solve.upload`` (u0 converted to the solve's dtype on the host,
then copied to the device), the program's making (``solve.program``, where
the multi-step program first meets its shape: ops/nonlocal_op.py,
models/steppers.py) and ``solve.fetch`` (the wait for the loop and the copy
back).  ``obs.metrics.REGISTRY`` counts ``/solver/solves`` (one a
``do_work``) and the bytes of the two copies where they cross to or from a
device that is not the CPU (``/solver/h2d-bytes``, ``/solver/d2h-bytes``).

``stepper``/``stages`` pick the time integrator (models/steppers.py: euler,
rkc, expo) in each form; an rkc or expo solve steps its own loop (each rkc
stage one ``op.apply``: on ``cuda`` one ``nsum2d`` launch), and the
throttle steps its step function.

Arrays are [x, y] of shape (nx, ny).  :class:`GridSolver` holds the set-up,
loops and checkpoint/resume (utils/checkpoint.py) that ``Solver3D``
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
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.metrics import REGISTRY
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, source_at
from nonlocalheatequation_torch.utils.checkpoint import CheckpointMixin, fetch_state
from nonlocalheatequation_torch.utils.devices import resolve_device, resolve_dtype

BACKENDS = ("oracle", "torch")


def ensemble_case_of(solver, shape, dh):
    """The port's EnsembleCase of a 1D, 2D or 3D solver (``dh`` is the 1D
    dx for rank 1); refuses a solve positioned past step 0."""
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase

    if solver.t0:
        raise ValueError("ensemble scheduling starts every case at t0=0; run a solve "
                         "positioned at a later step with do_work()")
    op = solver.op
    return EnsembleCase(shape=tuple(shape), nt=solver.nt, eps=op.eps, k=op.k, dt=op.dt,
                        dh=dh, test=solver.test, u0=solver.u0)


class GridSolver(CheckpointMixin, ManufacturedMetrics2D):
    """The set-up and time loops the 2D and 3D solvers share: the NumPy
    oracle and the device path over ``self.op`` on ``self._grid_shape``."""

    def _setup(self, op, backend: str, stepper: str, stages: int, logger, dtype, device,
               checkpoint_path, ncheckpoint: int, nd: int | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        self.op = op
        self.stepper, self.stages = validate_solver_stepper(op, backend, stepper, stages)
        self.backend = backend
        self.logger = logger
        self.nd = None if nd is None else int(nd)
        self.max_inflight_ = 0  # the throttle's peak of steps in flight
        self.checkpoint_path = checkpoint_path
        self.ncheckpoint = int(ncheckpoint)
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

    def ensemble_case(self):
        """This solve as a serve/ensemble batch case.  The CLIs' --ensemble
        mode collects one per solver, runs the batched engine, then feeds
        each returned state back through ``self.u`` and ``compute_l2``, so
        the error is computed by the solo path's code."""
        return ensemble_case_of(self, self._grid_shape, self.op.dh)

    # -- time loop (2d_nonlocal_serial.cpp:273-303) ---------------------------
    def do_work(self) -> np.ndarray:
        REGISTRY.counter("/solver/solves").inc()
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
            self._maybe_checkpoint(t, u)
        return u

    def _run_torch(self):
        g, lg = (self.op.source_parts_on(*self._grid_shape, self.device)
                 if self.test else (None, None))
        u = self._upload()
        kw = dict(stepper=self.stepper, stages=self.stages)
        checkpointing = bool(self.checkpoint_path and self.ncheckpoint)
        if self.logger is None and self.nd is None and not checkpointing:
            multi = make_multi_step_fn(self.op, self.nt - self.t0, g, lg, self.dtype, **kw)
            return self._fetch(multi(u, self.t0))
        if self.nd is None:
            # one multi-step program per segment; barriers = log and checkpoint steps
            return self._fetch(self._run_chunked(u, lambda count: make_multi_step_fn(
                self.op, count, g, lg, self.dtype, **kw)))
        return self._run_throttled(u, make_step_fn(self.op, g, lg, self.dtype, **kw))

    def _upload(self):
        """u0 on the device in the solve's dtype.  Toward a card torch
        converts on the host first, so the copy moves ``u.nbytes``.  A
        copy on the CPU too: the throttled loop steps into this buffer, and
        u0 (or the caller's input_init array) must not change."""
        with obs_trace.span("solve.upload"):
            u = torch.tensor(self.u0, device=self.device, dtype=self.dtype)
            if u.device.type != "cpu":
                REGISTRY.counter("/solver/h2d-bytes").inc(u.nbytes)
            return u

    def _fetch(self, u) -> np.ndarray:
        """The final state on the host: the wait for the loop and the copy
        back (its bytes counted)."""
        with obs_trace.span("solve.fetch"):
            out = u.cpu().numpy()
            if u.device.type != "cpu":
                REGISTRY.counter("/solver/d2h-bytes").inc(out.nbytes)
            return out

    def _run_throttled(self, u, step):
        """The per-step loop under the ``nd`` sliding semaphore.  Steps go
        into two buffers in turn (stream order makes the reuse safe); the
        throttle tracks events, never the buffers, which later steps
        overwrite.  On the CPU, where every step has finished when it
        returns, a marker takes the event's place, so ``max_inflight_``
        means the same."""
        on_card = u.device.type == "cuda"
        stream = torch.cuda.current_stream(u.device) if on_card else None
        spare = torch.empty_like(u)
        inflight = []
        self.max_inflight_ = 0
        for t in range(self.t0, self.nt):
            nxt = step(u, t, out=spare)
            spare, u = u, nxt
            if t % self.nlog == 0 and self.logger is not None:
                self.logger(t, fetch_state(u))
            self._maybe_checkpoint(t, u)
            if on_card:
                done = torch.cuda.Event()
                done.record(stream)
                inflight.append(done)
            else:
                inflight.append(t)
            if len(inflight) > self.nd:
                oldest = inflight.pop(0)
                if on_card:
                    oldest.synchronize()
            self.max_inflight_ = max(self.max_inflight_, len(inflight))
        return self._fetch(u)


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
        self.nx, self.ny = int(nx), int(ny)
        self.nt, self.eps, self.nlog = int(nt), int(eps), int(nlog)
        op = NonlocalOp2D(eps, k, dt, dh, method=method, precision=precision,
                          resync_every=resync_every)
        self._setup(op, backend, stepper, stages, logger, dtype, device, checkpoint_path,
                    ncheckpoint, nd)

    @property
    def _grid_shape(self):
        return (self.nx, self.ny)
