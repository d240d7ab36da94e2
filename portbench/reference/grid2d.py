"""Plain PyTorch reference of the 2D lattice deployment.

The operator of the reference code (src/2d_nonlocal_serial.cpp:76,231,
256-270; problem_description.tex:131-158), worked out here from the
configuration alone:

    L(u)[p] = c * h^2 * ( sum_{o in disc} ubar[p + o]  -  Wsum * u[p] )

with ``ubar`` u extended by zero outside the grid (the volumetric collar),
the disc the columns ``|o_y| <= trunc(sqrt(eps^2 - o_x^2))`` for
``|o_x| <= eps``, ``Wsum`` the disc's count, ``c = 8k / (eps*h)^4``, and
forward Euler ``u <- u + dt * L(u)``.

The disc sum runs as 2*eps+1 column windows over a prefix sum along y, in
float64: its rounding (about ny * 1e-16 of |u|) lies far below float32's.
``operand="bfloat16"`` rounds the state to bfloat16 before every neighbour
sum and centre term (summed in float64) and carries the state in float32:
the lower precision a program might be tempted to use, for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def half_heights(eps: int) -> list:
    """The disc's column half-heights at x offsets -eps..eps (the double to
    long truncation of the reference code)."""
    return [int(math.sqrt(eps * eps - i * i)) for i in range(-eps, eps + 1)]


def disc_count(eps: int) -> int:
    return sum(2 * h + 1 for h in half_heights(eps))


def scale(k: float, eps: int, h: float) -> float:
    """c * h^2 with c = 8k / (eps*h)^4."""
    return 8.0 * k / (eps * h) ** 4 * h * h


def euler_dt(k: float, eps: int, h: float, cfl: float) -> float:
    """``cfl`` times forward Euler's bound 2 / lambda_max, where the
    operator's spectrum lies in [-2 c h^2 Wsum, 0]."""
    return cfl / (scale(k, eps, h) * disc_count(eps))


def _disc_sum(u: torch.Tensor, eps: int, heights: list) -> torch.Tensor:
    nx, ny = u.shape[-2:]
    prefix = F.pad(torch.cumsum(F.pad(u, (eps, eps, eps, eps)), dim=-1), (1, 0))
    acc = torch.zeros_like(u)
    for i, h in enumerate(heights):
        acc += (prefix[..., i:i + nx, eps + h + 1:eps + h + 1 + ny]
                - prefix[..., i:i + nx, eps - h:eps - h + ny])
    return acc


def solve(u0: torch.Tensor, eps: int, k: float, h: float, dt: float, steps: int,
          operand: str = "float64") -> torch.Tensor:
    """``steps`` Euler steps of every field in ``u0`` (..., nx, ny); float64
    throughout, or with the bfloat16 operand of the control."""
    heights = half_heights(eps)
    wsum = float(disc_count(eps))
    ch2 = scale(k, eps, h)
    if operand == "bfloat16":
        u = u0.to(torch.float32)
        for _ in range(steps):
            v = u.to(torch.bfloat16).to(torch.float64)
            u = u + (dt * (ch2 * (_disc_sum(v, eps, heights) - wsum * v))).to(torch.float32)
        return u
    if operand != "float64":
        raise ValueError(f"operand {operand!r}: float64 or bfloat16")
    u = u0.to(torch.float64)
    for _ in range(steps):
        u = u + dt * (ch2 * (_disc_sum(u, eps, heights) - wsum * u))
    return u
