"""Distributed 3D solver over a 3D mesh of blocks — counterpart of
``nonlocalheatequation_tpu/parallel/distributed3d.py``.

The 2D design one rank up (parallel/distributed2d.py, whose
:class:`DistributedGridSolver` it shares): one block per position of a
Mesh('x', 'y', 'z'), an eps-band exchange on every mesh axis each step
(multi-hop when eps exceeds a block edge), ``comm="collective"``
(``op.apply_padded``, the ``nsum3d`` kernel with ``method="cuda"``) or
``"fused"`` (``fused_nsum3d``, the halo read inside the kernel, or after
the band copies ``split_nsum3d``; bitwise the same), and the
communication-avoiding superstep on the collective path.  The numerics are
the single-device 3D solve's; a logger and checkpoints run as in 2D, and a
checkpoint resumes in ``Solver3D`` and the reverse.  The stepper axis (rkc
per stage or in stage batches, expo) and the sharded spectral tier
(``method="fft"``, the 3D pencil transposes) run as in 2D.
"""

from __future__ import annotations

from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp3D
from nonlocalheatequation_torch.parallel.distributed2d import DistributedGridSolver
from nonlocalheatequation_torch.parallel.mesh import Mesh, device_list, make_mesh_3d


def choose_mesh_shape_3d(NX: int, NY: int, NZ: int, ndevices: int) -> tuple[int, int, int]:
    """Largest (mx, my, mz) whose shape divides the grid, product <=
    ndevices; among equal products the most cubic (the smallest halo
    surface per block)."""
    n = int(ndevices)
    best = (1, 1, 1)

    def better(c, b):
        pc, pb = c[0] * c[1] * c[2], b[0] * b[1] * b[2]
        return pc > pb or (pc == pb and max(c) < max(b))

    for mx in range(1, min(NX, n) + 1):
        if NX % mx:
            continue
        for my in range(1, min(NY, n // mx) + 1):
            if NY % my:
                continue
            for mz in range(1, min(NZ, n // (mx * my)) + 1):
                if NZ % mz == 0 and better((mx, my, mz), best):
                    best = (mx, my, mz)
    return best


def choose_mesh_for_grid_3d(NX: int, NY: int, NZ: int, devices=None) -> Mesh:
    """Largest mesh (mx, my, mz) whose shape divides the grid, product <=
    #devices (default :func:`device_list`, the CUDA cards)."""
    devices = list(devices if devices is not None else device_list())
    return make_mesh_3d(*choose_mesh_shape_3d(NX, NY, NZ, len(devices)), devices=devices)


class Solver3DDistributed(DistributedGridSolver):
    """Solve on the global (NX, NY, NZ) grid, sharded over a 3D mesh (the
    default mesh spans ``device_list(device)``)."""

    AXES = ("x", "y", "z")

    def __init__(self, NX: int, NY: int, NZ: int, nt: int, eps: int, nlog: int = 5,
                 k: float = 1.0, dt: float = 0.0005, dh: float = 0.05,
                 mesh: Mesh | None = None, method: str = "auto", logger=None, dtype=None,
                 checkpoint_path: str | None = None, ncheckpoint: int = 0,
                 superstep: int = 1, precision: str = "f32", comm: str = "collective",
                 stepper: str = "euler", stages: int = 0, device=None):
        self.NX, self.NY, self.NZ = int(NX), int(NY), int(NZ)
        self.nt, self.eps, self.nlog = int(nt), int(eps), int(nlog)
        op = NonlocalOp3D(eps, k, dt, dh, method=method, precision=precision)
        self._setup(op, mesh, device, dtype, superstep, comm, choose_mesh_for_grid_3d, logger,
                    checkpoint_path, ncheckpoint, stepper, stages)

    @property
    def _grid_shape(self):
        return (self.NX, self.NY, self.NZ)
