"""Manufactured-solution error metrics (reference: compute_l2/compute_linf,
src/2d_nonlocal_serial.cpp:96-113), computed on the host from the final state.

Rank-agnostic: mixed into the 1D, 2D and 3D solvers; expects ``self.op``,
``self.u`` (final state, a NumPy array) and ``self._grid_shape`` -> (NX,),
(NX, NY) or (NX, NY, NZ).
"""

import numpy as np


class ManufacturedMetrics2D:
    def compute_l2(self, t: int):
        d = self.u - self.op.manufactured_solution(*self._grid_shape, t)
        self.error_l2 = float(np.sum(d * d))
        return self.error_l2

    def compute_linf(self, t: int):
        d = self.u - self.op.manufactured_solution(*self._grid_shape, t)
        self.error_linf = float(np.max(np.abs(d))) if d.size else 0.0
        return self.error_linf

    #: the distributed print_error prefixes coordinates (2d_nonlocal_distributed.
    #: cpp:538-541); the serial binary does not (2d_nonlocal_serial.cpp:122)
    _cmp_coordinate_prefix = False

    def print_error(self, cmp: bool = False):
        print(f"l2: {self.error_l2:g} linfinity: {self.error_linf:g}")
        if cmp:
            expected = self.op.manufactured_solution(*self._grid_shape, self.nt)
            for idx in np.ndindex(*self._grid_shape):
                prefix = ("".join(f"s{'xyz'[d]}: {i} " for d, i in enumerate(idx))
                          if self._cmp_coordinate_prefix else "")
                print(f"{prefix}Expected: {expected[idx]:g} Actual: {self.u[idx]:g}")

    def print_soln(self):
        shape = self._grid_shape
        last = shape[-1]
        for lead in np.ndindex(*shape[:-1]):
            print(" ".join(
                "S" + "".join(f"[{i}]" for i in (*lead, sy)) + f" = {self.u[(*lead, sy)]:g}"
                for sy in range(last)))
