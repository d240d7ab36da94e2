"""The 2D lattice deployment: its inputs, the port's entry that serves it,
and its reference.

The configuration names the grid (``mesh``, its spacing ``dh``), the
operator (``eps``, ``k``), the time step ``dt`` and the steps of a solve
(``nt``); the traffic names the number of seeded initial fields
(``inputs``).  Each field is a sum of Gaussian bumps drawn from the seed on
the card, kept on the host in float64, the type ``Solver2D.input_init``
takes.  The entry is ``Solver2D.input_init`` + ``do_work`` (the tuned
multi-step program).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import yardstick
from portbench.reference import grid2d as ref

BUMPS = 16


def gaussian_fields(gen: torch.Generator, count: int, nx: int, ny: int, h: float,
                    device) -> torch.Tensor:
    """``count`` fields (count, nx, ny) float64, each a sum of BUMPS Gaussian
    bumps with centres in the unit square, widths 0.01-0.08 and amplitudes
    in [-1, 1], at the nodes (i * h, j * h): separable, one product a field."""
    draw = torch.rand((count, BUMPS, 4), generator=gen, device=device, dtype=torch.float64)
    x = torch.arange(nx, device=device, dtype=torch.float64) * h
    y = torch.arange(ny, device=device, dtype=torch.float64) * h
    cx, cy = draw[..., 0:1], draw[..., 1:2]
    width = 0.01 + 0.07 * draw[..., 2:3]
    amp = 2.0 * draw[..., 3:4] - 1.0
    gx = torch.exp(-((x - cx) / width) ** 2 / 2) * amp  # (count, BUMPS, nx)
    gy = torch.exp(-((y - cy) / width) ** 2 / 2)  # (count, BUMPS, ny)
    return gx.transpose(1, 2) @ gy


class Problem:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool):
        self.config, self.device = config, torch.device(device)
        self.nx, self.ny = (int(n) for n in config["mesh"])
        self.steps = int(config["nt"])
        self.eps, self.k = int(config["eps"]), float(config["k"])
        self.h, self.dt = float(config["dh"]), float(config["dt"])
        self.dtype = getattr(torch, config["dtype"])
        self.precision = "bf16" if control else "f32"
        self.points = self.nx * self.ny
        self.step_bytes = yardstick.least_step_bytes(self.points, self.dtype.itemsize)
        gen = torch.Generator(self.device).manual_seed(seed)
        fields = gaussian_fields(gen, int(traffic["inputs"]), self.nx, self.ny, self.h,
                                 self.device)
        self.inputs = list(fields.cpu().numpy())
        self._solver = None

    def solve(self, iid: int) -> np.ndarray:
        if self._solver is None:
            from nonlocalheatequation_torch.models.solver2d import Solver2D

            self._solver = Solver2D(self.nx, self.ny, self.steps, self.eps, k=self.k,
                                    dt=self.dt, dh=self.h, dtype=self.dtype,
                                    precision=self.precision, device=self.device)
        self._solver.input_init(self.inputs[iid])
        return self._solver.do_work()

    def close(self) -> None:
        self._solver = None

    def reference(self, iids) -> dict:
        """The reference's final state of each input in ``iids``, on the
        device, run together."""
        iids = sorted(set(iids))
        u0 = torch.as_tensor(np.stack([self.inputs[i] for i in iids])).to(self.device)
        out = ref.solve(u0, self.eps, self.k, self.h, self.dt, self.steps)
        return dict(zip(iids, out, strict=True))


def make(config: dict, traffic: dict, seed: int, device, control: bool = False) -> Problem:
    return Problem(config, traffic, seed, device, control)
