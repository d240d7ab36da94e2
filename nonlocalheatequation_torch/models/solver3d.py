"""3D nonlocal heat solver — the NumPy oracle and the device path.

Counterpart of ``nonlocalheatequation_tpu/models/solver3d.py`` (no 3D exists
in the reference; the discretization applies its 2D recipe once more per
axis and is held to the same manufactured-solution contract):

* ``backend="oracle"`` — NumPy float64, the serial time loop, the ground
  truth.
* ``backend="torch"`` (default) — the time loop on ``device`` (the CUDA card
  unless ``device="cpu"``).  On the card with ``method="cuda"``/``"auto"``
  the production solve goes through the tuner (per-step ``step3d``,
  ``carried3d``, or ``resident3d`` where the grid fits); the test form and a
  logged run launch the fused ``step3d`` once per step, and the test form's
  L(G) is evaluated on the device in float64 by the operator's own method
  (the ``nsum3d`` kernel on the card).  On the CPU ``auto`` is ``sat``.

Arrays are [x, y, z] of shape (nx, ny, nz).  ``ensemble_case()`` (from
:class:`GridSolver`) hands the solve to the ensemble engine
(serve/ensemble.py).  Checkpointing and the dispatch-ahead throttle ``nd``
are not ported yet; they are refused by name.
"""

from __future__ import annotations

from nonlocalheatequation_torch.models.solver2d import GridSolver, refuse_unported
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp3D


class Solver3D(GridSolver):
    def __init__(
        self,
        nx: int,
        ny: int,
        nz: int,
        nt: int,
        eps: int,
        nlog: int = 5,
        k: float = 1.0,
        dt: float = 0.0005,
        dh: float = 0.05,
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
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.nt, self.eps, self.nlog = int(nt), int(eps), int(nlog)
        op = NonlocalOp3D(eps, k, dt, dh, method=method, precision=precision,
                          resync_every=resync_every)
        self._setup(op, backend, stepper, stages, logger, dtype, device)

    @property
    def _grid_shape(self):
        return (self.nx, self.ny, self.nz)
