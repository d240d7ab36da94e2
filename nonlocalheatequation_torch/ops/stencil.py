"""Discrete horizon (stencil) geometry — the port's own copy.

The reference rasterizes the eps-ball as vertical line segments: for each x
offset ``i`` in [-eps, eps] the column half-height is
``len_i = (long)sqrt(eps*eps - i*i)`` — a double->long TRUNCATION
(src/2d_nonlocal_serial.cpp:231).  ``eps`` is an integer in grid units.  The
truncation defines the exact discrete stencil shape; the masks below are
bit-for-bit those of ``nonlocalheatequation_tpu/ops/stencil.py`` and every
other path of the port (plain versions, CUDA kernels) derives from them.

The center point is part of the stencil: it contributes ``u_j - u_i = 0`` to
the sum but counts toward the neighbor count, which matters because
out-of-domain points contribute ``0 - u_i`` (volumetric boundary condition).
"""

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def column_half_heights(eps: int) -> np.ndarray:
    """Half-height of the stencil column at each x offset in [-eps, eps].

    ``len_i = trunc(sqrt(eps^2 - i^2))`` computed in float64 exactly like the
    reference's ``len_1d_line`` (src/2d_nonlocal_serial.cpp:231).  The CUDA
    kernels compute the same expression in double on the host
    (csrc/nsum2d.cu, ``make_plan``).
    """
    i = np.arange(-eps, eps + 1, dtype=np.int64)
    out = np.sqrt(np.float64(eps * eps) - i.astype(np.float64) ** 2).astype(np.int64)
    out.setflags(write=False)  # cached: shared across callers
    return out


@lru_cache(maxsize=None)
def horizon_mask_1d(eps: int) -> np.ndarray:
    """1D stencil: every offset in [-eps, eps] (src/1d_nonlocal_serial.cpp:200)."""
    out = np.ones(2 * eps + 1, dtype=bool)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def horizon_mask_2d(eps: int) -> np.ndarray:
    """(2*eps+1, 2*eps+1) bool mask of the rasterized eps-circle.

    mask[i+eps, j+eps] is True iff |j| <= trunc(sqrt(eps^2 - i^2)).
    Axis 0 is the x offset, axis 1 the y offset.
    """
    heights = column_half_heights(eps)
    j = np.arange(-eps, eps + 1, dtype=np.int64)
    out = np.abs(j)[None, :] <= heights[:, None]
    out.setflags(write=False)
    return out


def influence_weights(mask: np.ndarray, influence=None, dh: float = 1.0) -> np.ndarray:
    """Per-offset weights J(distance) on the stencil, float64.

    The reference's influence function is J == 1 everywhere; pass
    ``influence`` (a callable of the euclidean offset distance in grid units
    times dh) to generalize.
    """
    w = mask.astype(np.float64)
    if influence is not None:
        eps = (mask.shape[0] - 1) // 2
        axes = np.arange(-eps, eps + 1, dtype=np.float64)
        grids = np.meshgrid(*([axes] * mask.ndim), indexing="ij")
        dist = np.sqrt(sum(g * g for g in grids)) * dh
        w = w * np.vectorize(influence)(dist)
    return w
