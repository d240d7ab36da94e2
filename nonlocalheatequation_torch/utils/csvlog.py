"""CSV + VTU simulation logging, column-compatible with the reference — the
port's own copy of ``nonlocalheatequation_tpu/utils/csvlog.py``.

The reference logs every ``nlog`` steps (2d_nonlocal_distributed.cpp:570-639):

* ``out_csv/simulate_2d.csv`` rows ``time,sx,sy,numeric,analytic,sq_err,abs_err,``
* a ``.vtu`` snapshot with a Temperature point array and a TIME field
* when testing, ``out_csv/score_2d.csv`` rows ``time,l2,linf,``

(1D analogues: 1d_nonlocal_serial.cpp:132-167, rows ``time,sx,...``).  Two
differences from the reference, the JAX package's too: the output
directories are created, and the TIME field records simulation time, not
the wall clock.  For the same states the files are byte for byte the JAX
logger's.  Under a multi-process launch every rank keeps its logger (the
logging steps are barriers, where the global state is gathered to every
rank) and rank 0 alone writes.
"""

from __future__ import annotations

import os

import numpy as np

from nonlocalheatequation_torch.utils.vtu import VtuWriter, writes_files


class SimulationCsvLogger:
    """Logger callable for the solvers' ``logger=`` hook: ``logger(t, u)``
    with ``u`` a host NumPy array.

    ``op`` is the solver's NonlocalOp1D/2D (its ``manufactured_solution``
    gives the analytic columns); ``test`` adds them and the score file.
    """

    def __init__(self, op, test: bool, out_csv: str = "out_csv", out_vtk: str = "out_vtk",
                 tag: str = "2d", nlog: int = 1, write_vtk: bool = True, compress: str = ""):
        self.op = op
        self.test = test
        self.tag = tag
        self.nlog = max(1, int(nlog))
        self.write_vtk = write_vtk
        self.compress = compress
        self.writer = writes_files()  # rank 0 alone logs under a multi-process launch
        if self.writer:
            os.makedirs(out_csv, exist_ok=True)
            if write_vtk:
                os.makedirs(out_vtk, exist_ok=True)
        self.simulate_path = os.path.join(out_csv, f"simulate_{tag}.csv")
        self.score_path = os.path.join(out_csv, f"score_{tag}.csv")
        self.out_vtk = out_vtk

    def __call__(self, t: int, u: np.ndarray):
        if not self.writer:
            return
        u = np.asarray(u)
        if u.ndim == 1:
            self._log_1d(t, u)
        else:
            self._log_2d(t, u)
        if self.write_vtk:
            self._log_vtk(t, u)
        if self.test:
            self._log_score(t, u)

    def _analytic(self, t: int, shape):
        return self.op.manufactured_solution(*shape, t)

    def _log_1d(self, t: int, u):
        w = self._analytic(t, u.shape)
        with open(self.simulate_path, "a") as f:
            for sx in range(u.shape[0]):
                d = u[sx] - w[sx]
                f.write(f"{t},{sx},{u[sx]:g},{w[sx]:g},{d * d:g},{abs(d):g},\n")

    def _log_2d(self, t: int, u):
        w = self._analytic(t, u.shape)
        with open(self.simulate_path, "a") as f:
            for sx in range(u.shape[0]):
                for sy in range(u.shape[1]):
                    d = u[sx, sy] - w[sx, sy]
                    f.write(f"{t},{sx},{sy},{u[sx, sy]:g},{w[sx, sy]:g},"
                            f"{d * d:g},{abs(d):g},\n")

    def _log_score(self, t: int, u):
        d = (u - self._analytic(t, u.shape)).ravel()
        l2 = float(d @ d)
        linf = float(np.max(np.abs(d))) if d.size else 0.0
        with open(self.score_path, "a") as f:
            f.write(f"{t},{l2:g},{linf:g},\n")

    def _log_vtk(self, t: int, u):
        wtr = VtuWriter(os.path.join(self.out_vtk, f"simulate_{t // self.nlog}"), self.compress)
        if u.ndim == 1:
            nodes = np.zeros((u.shape[0], 3))
            nodes[:, 0] = np.arange(u.shape[0])
            values = u
        else:
            nx, ny = u.shape
            # node (sx, sy) at flat index sx + sy*nx, the reference's layout
            # (2d_nonlocal_serial.cpp:83-88)
            gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
            nodes = np.zeros((nx * ny, 3))
            nodes[:, 0] = gx.ravel()
            nodes[:, 1] = gy.ravel()
            values = u.T.ravel()
        wtr.append_nodes(nodes)
        wtr.append_point_data("Temperature", values)
        wtr.add_time_step(t * self.op.dt)
        wtr.close()
