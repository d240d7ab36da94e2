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


@lru_cache(maxsize=None)
def horizon_mask_3d(eps: int) -> np.ndarray:
    """(2*eps+1,)*3 bool mask of the rasterized eps-sphere.

    The column raster once more per axis: mask[i+eps, j+eps, k+eps] is True
    iff i^2 + j^2 <= eps^2 and |k| <= trunc(sqrt(eps^2 - i^2 - j^2)).  257
    points at eps=4, 925 at eps=6.
    """
    i = np.arange(-eps, eps + 1, dtype=np.int64)
    rem = np.float64(eps * eps) - i[:, None] ** 2 - i[None, :] ** 2
    heights = np.where(rem >= 0, np.sqrt(np.maximum(rem.astype(np.float64), 0.0)), -1.0)
    heights = np.trunc(heights).astype(np.int64)
    out = np.abs(i)[None, None, :] <= heights[:, :, None]
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def sphere_column_heights(eps: int) -> np.ndarray:
    """(2*eps+1, 2*eps+1) half-heights along z of the sphere's columns, read
    off the mask itself (so the raster rule lives in horizon_mask_3d only);
    -1 where the column (i, j) lies outside the sphere.  49 columns at
    eps=4, 113 at eps=6.  The CUDA kernels compute the same heights in double
    on the host (csrc/stencil_tile3d.cuh, ``make_plan3``)."""
    colsum = horizon_mask_3d(eps).sum(axis=2).astype(np.int64)
    out = np.where(colsum > 0, (colsum - 1) // 2, -1)
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
