"""The nonlocal horizon operator in PyTorch — counterpart of
``nonlocalheatequation_tpu/ops/nonlocal_op.py``.

Semantics (the reference's, unchanged):

    L(u)[p] = c * h^d * ( sum_{o in mask} J(o) * ubar[p+o]  -  Wsum * u[p] )

with ``ubar`` u extended by 0 outside the domain (volumetric boundary
condition), ``mask`` the rasterized eps-ball (ops/stencil.py) and
``Wsum = sum_o J(o)``.  Forward Euler: ``u^{t+1} = u^t + dt*(L(u^t) + b_t)``
with the manufactured source ``b_t = -2*pi*sin(2*pi*t*dt)*G - cos(2*pi*t*dt)*L(G)``.

Evaluation methods of the 2D neighbour sum (identical up to float addition
order):

* ``shift`` — one slice-add per mask offset (the reference's loop).
* ``conv``  — ``F.conv2d`` with the mask as kernel.  TF32 is switched off
  around every call, so an f32 conv on the card runs in full f32.
* ``sat``   — per-column running sums along y: O(eps) slices per point;
  prefix-sum differencing carries absolute error ~ny*|u| (use it in f64).
* ``cuda``  — the hand-written kernels (ops/cuda_kernel.py): ``nsum2d`` for
  the neighbour sum, and the fused ``step2d`` for a whole Euler step.  On a
  CPU tensor the wrappers run their plain versions.
* ``fft``   — the padded-box rFFT (ops/spectral.py): O(N log N), eps
  independent, within 1e-12 of the stencil methods, whole-domain entry
  points only (the padded ones refuse it).
* ``auto``  — ``cuda`` on a CUDA tensor, ``conv`` on the CPU; never ``fft``.

A weighted influence function J demotes ``sat``/``cuda``/``auto`` to
``conv`` (the kernels sum a 0/1 mask); ``fft`` bakes the weights into its
symbol and stays.  The 3D operator (:class:`NonlocalOp3D`) has ``shift``,
``sat``, ``cuda`` (``nsum3d``/``step3d``), ``fft`` and ``auto`` (``sat`` on
the CPU); its weighted J demotes to ``shift``.  The 1D operator has
``shift`` and ``fft``.

Precision tiers (ops/constants.py): ``"bf16"`` evaluates every neighbour sum
and the matching ``Wsum*u`` center term on the bfloat16 rounding of the
state, accumulated in the state dtype, while the carry ``u + dt*du`` stays
in the state dtype; ``resync_every=R`` evaluates every R-th step at full
precision.

All functions take tensors on any device and keep results there; host-side
set-up (G, L(G) in NumPy float64 for the oracle) is NumPy.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.ops import cuda_kernel, cuda_kernel3d, spectral
from nonlocalheatequation_torch.ops.constants import c_1d, c_2d, c_3d, validate_precision
from nonlocalheatequation_torch.ops.cuda_kernel import bf16_round
from nonlocalheatequation_torch.ops.stencil import (
    column_half_heights,
    horizon_mask_1d,
    horizon_mask_2d,
    horizon_mask_3d,
    influence_weights,
    sphere_column_heights,
)

TWO_PI = 2.0 * np.pi
METHODS_1D = ("shift", "fft")
METHODS_2D = ("shift", "conv", "sat", "cuda", "fft", "auto")
METHODS_3D = ("shift", "sat", "cuda", "fft", "auto")


def _check_method(method: str, methods: tuple) -> None:
    if method not in methods:
        raise ValueError(f"unknown method {method!r}; one of {methods}")


def _refuse_fft_padded(op, stencils: str) -> None:
    """The padded entry points never serve fft: a block's halo carries
    neighbour data, not the zero collar the embedding needs."""
    if op.method == "fft":
        raise ValueError(
            "method='fft' serves whole-domain (volumetric-collar) solves only; "
            f"halo-padded block evaluation (distributed/fused-comm paths) needs {stencils}")


@contextlib.contextmanager
def full_fp32():
    """Run cuDNN convolutions and matmuls in full float32 (no TF32); the
    previous flags are restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


class _PrecisionPolicy:
    """Validated ``precision``/``resync_every`` and the tier's operand
    transform, applied to every neighbour-sum input and center term."""

    def _init_precision(self, precision: str, resync_every: int) -> None:
        self.precision = validate_precision(precision)
        self.resync_every = int(resync_every)
        if self.resync_every < 0:
            raise ValueError(f"resync_every must be >= 0, got {resync_every}")
        if self.resync_every and self.precision == "f32":
            raise ValueError(
                "resync_every is a bf16-tier knob; precision='f32' already "
                "evaluates every step at full precision")

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        return bf16_round(x) if self.precision == "bf16" else x


class NonlocalOp1D(_PrecisionPolicy):
    """1D horizon operator (reference: src/1d_nonlocal_serial.cpp:198-206).
    Methods ``shift`` (the reference's slice-add loop) and ``fft``; 1D has no
    kernel."""

    def __init__(self, eps: int, k: float, dt: float, dx: float, influence=None,
                 method: str = "shift", precision: str = "f32", resync_every: int = 0):
        _check_method(method, METHODS_1D)
        self.eps = int(eps)
        self.k = float(k)
        self.dt = float(dt)
        self.dx = float(dx)
        self.c = c_1d(k, eps, dx)
        self.weights = influence_weights(horizon_mask_1d(self.eps), influence, dx)
        self.wsum = float(self.weights.sum())
        self._influence = influence
        self.uniform = influence is None
        self.method = method
        self._init_precision(precision, resync_every)

    def with_precision(self, precision: str, resync_every: int = 0) -> "NonlocalOp1D":
        return NonlocalOp1D(self.eps, self.k, self.dt, self.dx, influence=self._influence,
                            method=self.method, precision=precision,
                            resync_every=resync_every)

    def with_method(self, method: str) -> "NonlocalOp1D":
        """Twin operator differing only in method (the tuner's fft probe)."""
        return NonlocalOp1D(self.eps, self.k, self.dt, self.dx, influence=self._influence,
                            method=method, precision=self.precision,
                            resync_every=self.resync_every)

    def neighbor_sum_np(self, u: np.ndarray) -> np.ndarray:
        nx = u.shape[0]
        up = np.zeros(nx + 2 * self.eps, dtype=u.dtype)
        up[self.eps:self.eps + nx] = u
        acc = np.zeros_like(u)
        for o in range(2 * self.eps + 1):
            w = self.weights[o]
            if w:
                acc += w * up[o:o + nx]
        return acc

    def neighbor_sum(self, u: torch.Tensor) -> torch.Tensor:
        if self.method == "fft":
            return spectral.neighbor_sum_fft(self, self._operand(u))
        up = self._operand(F.pad(u, (self.eps, self.eps)))
        nx = u.shape[0]
        acc = torch.zeros_like(u)
        for o in range(2 * self.eps + 1):
            w = float(self.weights[o])
            if w:
                acc = acc + w * up[o:o + nx]
        return acc

    def apply_np(self, u: np.ndarray) -> np.ndarray:
        return self.c * self.dx * (self.neighbor_sum_np(u) - self.wsum * u)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        return self.c * self.dx * (self.neighbor_sum(u) - self.wsum * self._operand(u))

    def spatial_profile(self, nx: int, x0: int = 0) -> np.ndarray:
        """G[x] = sin(2*pi*(x*dx)) for global positions x0..x0+nx."""
        x = np.arange(x0, x0 + nx, dtype=np.float64)
        return np.sin(TWO_PI * (x * self.dx))

    def source_parts(self, nx: int):
        """(G, L(G)) for the manufactured source (1d_nonlocal_serial.cpp:186-195)."""
        g = self.spatial_profile(nx)
        return g, self.apply_np(g)

    def manufactured_solution(self, nx: int, t: int) -> np.ndarray:
        return np.cos(TWO_PI * (t * self.dt)) * self.spatial_profile(nx)


class NonlocalOp2D(_PrecisionPolicy):
    """2D horizon operator (reference: src/2d_nonlocal_serial.cpp:256-270).

    Arrays are indexed [x, y] with shape (nx, ny)."""

    def __init__(self, eps: int, k: float, dt: float, dh: float, influence=None,
                 method: str = "auto", precision: str = "f32", resync_every: int = 0):
        _check_method(method, METHODS_2D)
        self.eps = int(eps)
        self.k = float(k)
        self.dt = float(dt)
        self.dh = float(dh)
        self.c = c_2d(k, eps, dh)
        self.mask = horizon_mask_2d(self.eps)
        self._influence = influence
        self.weights = influence_weights(self.mask, influence, dh)
        self.wsum = float(self.weights.sum())
        self.uniform = influence is None  # J == 1: sat/cuda paths are valid
        if method in ("sat", "cuda", "auto") and not self.uniform:
            method = "conv"
        self.method = method
        self._init_precision(precision, resync_every)

    def with_precision(self, precision: str, resync_every: int = 0) -> "NonlocalOp2D":
        """Twin operator differing only in precision tier."""
        return NonlocalOp2D(self.eps, self.k, self.dt, self.dh, influence=self._influence,
                            method=self.method, precision=precision,
                            resync_every=resync_every)

    def with_method(self, method: str) -> "NonlocalOp2D":
        """Twin operator differing only in method (the tuner's fft probe)."""
        return NonlocalOp2D(self.eps, self.k, self.dt, self.dh, influence=self._influence,
                            method=method, precision=self.precision,
                            resync_every=self.resync_every)

    def resolve_method(self, device: torch.device) -> str:
        """Concrete method for tensors on ``device``: ``auto`` is ``cuda`` on
        the card and ``conv`` on the CPU (the kernels' plain versions are
        slice loops, slower there than conv)."""
        if self.method != "auto":
            return self.method
        return "cuda" if torch.device(device).type == "cuda" else "conv"

    # -- neighbour sum --------------------------------------------------------
    def neighbor_sum_np(self, u: np.ndarray) -> np.ndarray:
        """Oracle path: per-offset shifted adds over the masked circle."""
        nx, ny = u.shape
        e = self.eps
        up = np.zeros((nx + 2 * e, ny + 2 * e), dtype=u.dtype)
        up[e:e + nx, e:e + ny] = u
        acc = np.zeros_like(u)
        heights = column_half_heights(e)
        for i in range(2 * e + 1):
            h = int(heights[i])
            for j in range(e - h, e + h + 1):
                w = self.weights[i, j]
                if w == 1.0:
                    acc += up[i:i + nx, j:j + ny]
                elif w:
                    acc += w * up[i:i + nx, j:j + ny]
        return acc

    def neighbor_sum(self, u: torch.Tensor) -> torch.Tensor:
        if self.method == "fft":
            return spectral.neighbor_sum_fft(self, self._operand(u))
        e = self.eps
        return self.neighbor_sum_padded(F.pad(u, (e, e, e, e)))

    def neighbor_sum_padded(self, upad: torch.Tensor) -> torch.Tensor:
        """Valid-mode neighbour sum of a halo-padded (nx+2e, ny+2e) block."""
        _refuse_fft_padded(self, "cuda/sat/conv/shift")
        method = self.resolve_method(upad.device)
        if method == "cuda":
            return cuda_kernel.nsum2d(upad, self.eps, self.precision)
        if method == "conv":
            return self._neighbor_sum_conv(upad)
        if method == "sat":
            return self._neighbor_sum_sat(upad)
        return self._neighbor_sum_shift(upad)

    def _neighbor_sum_conv(self, upad: torch.Tensor) -> torch.Tensor:
        upad = self._operand(upad)
        kern = torch.as_tensor(self.weights, dtype=upad.dtype, device=upad.device)
        with full_fp32():
            return F.conv2d(upad[None, None], kern[None, None])[0, 0]

    def _neighbor_sum_shift(self, upad: torch.Tensor) -> torch.Tensor:
        e = self.eps
        upad = self._operand(upad)
        nx, ny = upad.shape[0] - 2 * e, upad.shape[1] - 2 * e
        acc = torch.zeros((nx, ny), dtype=upad.dtype, device=upad.device)
        heights = column_half_heights(e)
        for i in range(2 * e + 1):
            h = int(heights[i])
            for j in range(e - h, e + h + 1):
                w = float(self.weights[i, j])
                if w:
                    term = upad[i:i + nx, j:j + ny]
                    acc = acc + (term if w == 1.0 else w * term)
        return acc

    def _neighbor_sum_sat(self, upad: torch.Tensor) -> torch.Tensor:
        """Column running sums: the window at x-offset i spans y offsets
        [-h_i, h_i]; with an exclusive prefix sum P along y it is
        P[y + h_i + 1] - P[y - h_i] on the padded array."""
        e = self.eps
        upad = self._operand(upad)
        nx, ny = upad.shape[0] - 2 * e, upad.shape[1] - 2 * e
        p = F.pad(torch.cumsum(upad, dim=1), (1, 0))
        acc = torch.zeros((nx, ny), dtype=upad.dtype, device=upad.device)
        heights = column_half_heights(e)
        for i in range(2 * e + 1):
            h = int(heights[i])
            hi = p[i:i + nx, e + h + 1:e + h + 1 + ny]
            lo = p[i:i + nx, e - h:e - h + ny]
            acc = acc + (hi - lo)
        return acc

    # -- operator and source -----------------------------------------------------
    def apply_np(self, u: np.ndarray) -> np.ndarray:
        return self.c * self.dh * self.dh * (self.neighbor_sum_np(u) - self.wsum * u)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        return self.c * self.dh * self.dh * (
            self.neighbor_sum(u) - self.wsum * self._operand(u))

    def apply_padded(self, upad: torch.Tensor) -> torch.Tensor:
        """L(u) for a halo-padded block: returns the (nx, ny) interior result."""
        e = self.eps
        center = self._operand(upad[e:upad.shape[0] - e, e:upad.shape[1] - e])
        return self.c * self.dh * self.dh * (
            self.neighbor_sum_padded(upad) - self.wsum * center)

    def spatial_profile(self, nx: int, ny: int, x0: int = 0, y0: int = 0) -> np.ndarray:
        """G[x,y] = sin(2*pi*x*dh) * sin(2*pi*y*dh) on global coords."""
        x = np.arange(x0, x0 + nx, dtype=np.float64)
        y = np.arange(y0, y0 + ny, dtype=np.float64)
        return np.outer(np.sin(TWO_PI * (x * self.dh)), np.sin(TWO_PI * (y * self.dh)))

    def source_parts(self, nx: int, ny: int):
        """(G, L(G)) in NumPy float64, zero extension outside the domain."""
        g = self.spatial_profile(nx, ny)
        return g, self.apply_np(g)

    def source_parts_on(self, nx: int, ny: int, device) -> tuple:
        """(G, L(G)) as float64 tensors on ``device``: L(G) is evaluated by
        this operator's own method there (the ``nsum2d`` kernel on the card)
        at full precision, whatever the tier."""
        g = torch.as_tensor(self.spatial_profile(nx, ny), device=device)
        return g, self.with_precision("f32").apply(g)

    def manufactured_solution(self, nx: int, ny: int, t: int) -> np.ndarray:
        return np.cos(TWO_PI * (t * self.dt)) * self.spatial_profile(nx, ny)


class NonlocalOp3D(_PrecisionPolicy):
    """3D horizon operator (no 3D exists in the reference; the JAX package's
    extension, ``nonlocalheatequation_tpu/ops/nonlocal_op.py:830``): the
    eps-sphere rasterized column by column (ops/stencil.horizon_mask_3d),
    node volume dh^3, scaling constant ops/constants.c_3d.  Arrays are
    [x, y, z] of shape (nx, ny, nz).

    Methods: ``shift`` sums one padded slice per sphere offset; ``sat`` adds
    a z prefix sum so each column is one window difference (use it in f64);
    ``cuda`` runs the hand-written kernels (ops/cuda_kernel3d.py: ``nsum3d``
    for the sum, the fused ``step3d`` for a whole Euler step; their plain
    versions on a CPU tensor); ``fft`` the padded-box rFFT (ops/spectral.py,
    whole-domain entry points only); ``auto`` is ``cuda`` on a CUDA tensor
    and ``sat`` on the CPU, as the JAX package picks ``sat`` off the TPU.  A
    weighted J demotes ``sat``/``cuda``/``auto`` to ``shift``.
    """

    def __init__(self, eps: int, k: float, dt: float, dh: float, influence=None,
                 method: str = "auto", precision: str = "f32", resync_every: int = 0):
        _check_method(method, METHODS_3D)
        self.eps = int(eps)
        self.k = float(k)
        self.dt = float(dt)
        self.dh = float(dh)
        self.c = c_3d(k, eps, dh)
        self.mask = horizon_mask_3d(self.eps)
        self._influence = influence
        self.weights = influence_weights(self.mask, influence, dh)
        self.wsum = float(self.weights.sum())
        self.uniform = influence is None
        if method in ("sat", "cuda", "auto") and not self.uniform:
            method = "shift"
        self.method = method
        self._init_precision(precision, resync_every)
        self._zh = sphere_column_heights(self.eps)  # -1: column outside the sphere

    def with_precision(self, precision: str, resync_every: int = 0) -> "NonlocalOp3D":
        """Twin operator differing only in precision tier."""
        return NonlocalOp3D(self.eps, self.k, self.dt, self.dh, influence=self._influence,
                            method=self.method, precision=precision,
                            resync_every=resync_every)

    def with_method(self, method: str) -> "NonlocalOp3D":
        """Twin operator differing only in method (the tuner's fft probe)."""
        return NonlocalOp3D(self.eps, self.k, self.dt, self.dh, influence=self._influence,
                            method=method, precision=self.precision,
                            resync_every=self.resync_every)

    def resolve_method(self, device: torch.device) -> str:
        """Concrete method for tensors on ``device``: ``auto`` is ``cuda`` on
        the card and ``sat`` on the CPU."""
        if self.method != "auto":
            return self.method
        return "cuda" if torch.device(device).type == "cuda" else "sat"

    def _columns(self):
        """(i, j, h) of every column of the sphere, i then j ascending."""
        e = self.eps
        return [(i, j, int(self._zh[i, j])) for i in range(2 * e + 1)
                for j in range(2 * e + 1) if self._zh[i, j] >= 0]

    # -- neighbour sum --------------------------------------------------------
    def neighbor_sum_np(self, u: np.ndarray) -> np.ndarray:
        """Oracle path: per-offset shifted adds over the masked sphere."""
        nx, ny, nz = u.shape
        e = self.eps
        up = np.zeros((nx + 2 * e, ny + 2 * e, nz + 2 * e), dtype=u.dtype)
        up[e:e + nx, e:e + ny, e:e + nz] = u
        acc = np.zeros_like(u)
        for i, j, h in self._columns():
            for kk in range(e - h, e + h + 1):
                w = self.weights[i, j, kk]
                if w == 1.0:
                    acc += up[i:i + nx, j:j + ny, kk:kk + nz]
                elif w:
                    acc += w * up[i:i + nx, j:j + ny, kk:kk + nz]
        return acc

    def neighbor_sum(self, u: torch.Tensor) -> torch.Tensor:
        if self.method == "fft":
            return spectral.neighbor_sum_fft(self, self._operand(u))
        return self.neighbor_sum_padded(F.pad(u, (self.eps,) * 6))

    def neighbor_sum_padded(self, upad: torch.Tensor) -> torch.Tensor:
        """Valid-mode neighbour sum of a halo-padded (nx+2e, ny+2e, nz+2e) block."""
        _refuse_fft_padded(self, "cuda/sat/shift")
        method = self.resolve_method(upad.device)
        if method == "cuda":
            return cuda_kernel3d.nsum3d(upad, self.eps, self.precision)
        if method == "sat":
            return self._neighbor_sum_sat(upad)
        return self._neighbor_sum_shift(upad)

    def _neighbor_sum_shift(self, upad: torch.Tensor) -> torch.Tensor:
        e = self.eps
        upad = self._operand(upad)
        nx, ny, nz = (s - 2 * e for s in upad.shape)
        acc = torch.zeros((nx, ny, nz), dtype=upad.dtype, device=upad.device)
        for i, j, h in self._columns():
            for kk in range(e - h, e + h + 1):
                w = float(self.weights[i, j, kk])
                if w:
                    term = upad[i:i + nx, j:j + ny, kk:kk + nz]
                    acc = acc + (term if w == 1.0 else w * term)
        return acc

    def _neighbor_sum_sat(self, upad: torch.Tensor) -> torch.Tensor:
        """z prefix sums: column (i, j) spans z offsets [-h, h]; with an
        exclusive prefix sum P along z it is P[z + h + 1] - P[z - h] on the
        padded array."""
        e = self.eps
        upad = self._operand(upad)
        nx, ny, nz = (s - 2 * e for s in upad.shape)
        p = F.pad(torch.cumsum(upad, dim=2), (1, 0))
        acc = torch.zeros((nx, ny, nz), dtype=upad.dtype, device=upad.device)
        for i, j, h in self._columns():
            hi = p[i:i + nx, j:j + ny, e + h + 1:e + h + 1 + nz]
            lo = p[i:i + nx, j:j + ny, e - h:e - h + nz]
            acc = acc + (hi - lo)
        return acc

    # -- operator and source -----------------------------------------------------
    def apply_np(self, u: np.ndarray) -> np.ndarray:
        return self.c * self.dh**3 * (self.neighbor_sum_np(u) - self.wsum * u)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        return self.c * self.dh**3 * (self.neighbor_sum(u) - self.wsum * self._operand(u))

    def apply_padded(self, upad: torch.Tensor) -> torch.Tensor:
        """L(u) for a halo-padded block: returns the (nx, ny, nz) interior result."""
        e = self.eps
        center = self._operand(upad[e:upad.shape[0] - e, e:upad.shape[1] - e,
                                    e:upad.shape[2] - e])
        return self.c * self.dh**3 * (self.neighbor_sum_padded(upad) - self.wsum * center)

    def spatial_profile(self, nx: int, ny: int, nz: int, x0: int = 0, y0: int = 0,
                        z0: int = 0) -> np.ndarray:
        """G = sin(2*pi*x*dh) sin(2*pi*y*dh) sin(2*pi*z*dh) on global coords."""
        ax, ay, az = (np.sin(TWO_PI * (np.arange(o, o + n, dtype=np.float64) * self.dh))
                      for o, n in ((x0, nx), (y0, ny), (z0, nz)))
        return ax[:, None, None] * ay[None, :, None] * az[None, None, :]

    def source_parts(self, nx: int, ny: int, nz: int):
        """(G, L(G)) in NumPy float64, zero extension outside the domain."""
        g = self.spatial_profile(nx, ny, nz)
        return g, self.apply_np(g)

    def source_parts_on(self, nx: int, ny: int, nz: int, device) -> tuple:
        """(G, L(G)) as float64 tensors on ``device``: L(G) is evaluated by
        this operator's own method there (the ``nsum3d`` kernel on the card)
        at full precision, whatever the tier."""
        g = torch.as_tensor(self.spatial_profile(nx, ny, nz), device=device)
        return g, self.with_precision("f32").apply(g)

    def manufactured_solution(self, nx: int, ny: int, nz: int, t: int) -> np.ndarray:
        return np.cos(TWO_PI * (t * self.dt)) * self.spatial_profile(nx, ny, nz)


def source_at(g, lg, t, dt):
    """b_t from precomputed (G, L(G)); NumPy arrays or tensors."""
    ang = TWO_PI * (t * dt)
    if isinstance(g, np.ndarray):
        return -TWO_PI * np.sin(ang) * g - np.cos(ang) * lg
    return -TWO_PI * math.sin(ang) * g - math.cos(ang) * lg


def case_scale(op) -> float:
    """The node-volume scale c*h^d as one host float, in the same expression
    order as apply() (the fused kernels multiply by this).  3D is
    ``c * dh**3``, not ``c*dh*dh*dh``, which rounds twice and can differ in
    the last bit, as the JAX package writes it."""
    if op.weights.ndim == 1:
        return op.c * op.dx
    if op.weights.ndim == 3:
        return op.c * op.dh**3
    return op.c * op.dh * op.dh


class _Sources:
    """(G, L(G)) converted once per (device, dtype) a step runs on."""

    def __init__(self, g, lg):
        self.g, self.lg = g, lg
        self._cache: dict = {}

    def on(self, like: torch.Tensor):
        key = (like.device, like.dtype)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(a).to(device=like.device, dtype=like.dtype).contiguous()
                for a in (self.g, self.lg))
        return self._cache[key]


def make_step_fn(op, g=None, lg=None, dtype=None):
    """The forward-Euler step ``step(u, t, out=None) -> u_next``.

    With (g, lg) (NumPy arrays or tensors) the manufactured test source is
    added.  A 2D or 3D operator whose method resolves to ``cuda`` for
    ``u``'s device runs the fused ``step2d``/``step3d`` kernel, which writes
    into ``out`` when given (a buffer that must not overlap ``u``); the other
    methods, ``fft`` among them, compute ``u + dt*(L(u) + b_t)`` with tensor
    ops and return a new tensor.  Use the returned tensor either way.
    """
    sources = _Sources(g, lg) if g is not None else None
    fused = {NonlocalOp2D: cuda_kernel.step2d, NonlocalOp3D: cuda_kernel3d.step3d}.get(type(op))
    scale = case_scale(op)

    def step(u, t, out=None):
        if dtype is not None and u.dtype != dtype:
            u = u.to(dtype)
        gd, lgd = sources.on(u) if sources is not None else (None, None)
        if fused is not None and op.resolve_method(u.device) == "cuda":
            return fused(u, op.eps, scale, op.wsum, op.dt, g=gd, lg=lgd, t=t,
                         precision=op.precision, out=out)
        du = op.apply(u)
        if sources is not None:
            du = du + source_at(gd, lgd, t, op.dt)
        return u + op.dt * du

    return step


def make_multi_step_fn(op, nsteps: int, g=None, lg=None, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` forward-Euler steps.

    The production (source-free) 2D solve whose method resolves to ``cuda``
    for ``u``'s device has four interchangeable programs, bit-identical by
    construction (they share csrc/stencil_tile.cuh): the per-step loop
    (:func:`make_multi_step_fn_base`, one ``step2d`` per step), the carried
    frame (``carried2d``), K-step temporal blocking (``superstep2d``) and
    the whole run in one launch (``resident2d``).  The 3D solve has three
    (csrc/stencil_tile3d.cuh): the per-step loop (``step3d``), the carried
    frame (``carried3d``) and the whole run in one launch (``resident3d``).
    On a CUDA tensor utils/autotune measures the candidates that fit once
    per (shape, dtype) and runs the fastest, as the JAX package's default
    does on the TPU; with the program store on (serve/program_store.py) a
    warm solve re-makes the stored winner without a probe.  The making (a
    key's first call) runs in a ``solve.program`` span (obs/trace.py).

    Everything else runs the per-step loop: a CPU tensor, the test form
    with its source, the 1D operator, a method that is not ``cuda``, and the
    bf16 tier with ``resync_every`` (its periodic full-precision step lives
    only on the loop).  The JAX package's manual knobs (``NLHEAT_AUTOTUNE``,
    ``NLHEAT_RESIDENT``, ``NLHEAT_SUPERSTEP``) have no counterpart here: the
    makers in ops/cuda_kernel.py build one variant directly.  ``u`` is never
    written.
    """
    base = make_multi_step_fn_base(op, nsteps, g, lg, dtype)
    if (g is not None or nsteps <= 0 or not isinstance(op, (NonlocalOp2D, NonlocalOp3D))
            or (op.precision == "bf16" and op.resync_every > 0)):
        return base

    def variant(u):
        if u.device.type != "cuda" or op.resolve_method(u.device) != "cuda":
            return base
        # the tuner's pick, through the program store when it is on (a warm
        # solve re-makes the stored winner and probes nothing)
        from nonlocalheatequation_torch.serve.program_store import solo_pick

        return solo_pick(op, nsteps, tuple(u.shape), dtype or u.dtype, u.device)

    built: dict = {}

    def multi(u, t0):
        key = (tuple(u.shape), dtype or u.dtype, u.device)
        fn = built.get(key)
        if fn is None:
            with obs_trace.span("solve.program"):
                fn = built[key] = variant(u)
        return fn(u, t0)

    return multi


def make_multi_step_fn_base(op, nsteps: int, g=None, lg=None, dtype=None):
    """The per-step loop of :func:`make_multi_step_fn` (always available).

    The loop launches one step per iteration into two buffers allocated once
    per call and used in turn, so the fused kernel path allocates no tensor
    per step; ``u`` itself is never written (the JAX package donates its
    state on the TPU, utils/donation.py; nothing here needs that).  bf16
    tier with ``resync_every=R``: every R-th step (absolute step index) runs
    on the unrounded state through an f32-tier twin operator.
    """
    step = make_step_fn(op, g, lg, dtype)
    resync = op.precision == "bf16" and op.resync_every > 0
    step_hi = make_step_fn(op.with_precision("f32"), g, lg, dtype) if resync else None

    def multi(u, t0):
        cur = u.to(dtype=dtype or u.dtype, memory_format=torch.contiguous_format,
                   copy=True)
        spare = torch.empty_like(cur)
        for t in range(t0, t0 + nsteps):
            fn = step_hi if resync and (t + 1) % op.resync_every == 0 else step
            nxt = fn(cur, t, out=spare)
            spare, cur = cur, nxt
        return cur

    return multi


# -- the ensemble engine's batched compositions (serve/ensemble.py) -------------------

def check_bucket_ops(ops) -> None:
    """Validate that a batched-ensemble bucket's operators run together:
    same class and eps (so one mask and wsum), the uniform influence
    function, one precision tier, and no ``resync_every`` (the periodic
    full-precision step lives on the solo per-step loop only)."""
    op0 = ops[0]
    for i, op in enumerate(ops):
        if type(op) is not type(op0) or op.eps != op0.eps:
            raise ValueError(
                f"ensemble bucket mixes operators (case {i}: {type(op).__name__}/eps={op.eps} "
                f"vs {type(op0).__name__}/eps={op0.eps}); bucket keys must pin (shape, eps)")
        if not op.uniform:
            raise ValueError("the batched ensemble paths serve the uniform influence "
                             f"function only (case {i} has a weighted J)")
        if op.precision != op0.precision:
            raise ValueError(f"ensemble bucket mixes precision tiers (case {i}); the bucket "
                             "key must pin the tier")
        if op.resync_every:
            raise ValueError("resync_every is a solo per-step knob; the batched ensemble "
                             f"paths refuse it (case {i}) rather than silently dropping the "
                             "full-precision steps")


def make_batched_multi_step_fn_vmap(ops, nsteps: int, dtype=None, test: bool = False,
                                    gs=None, lgs=None):
    """``multi(U, t0) -> U`` after ``nsteps`` steps of every case of the
    ``(B, *shape)`` stack, B = len(ops): the ensemble engine's parity oracle
    and its composition for 1D and 3D buckets.

    The counterpart of ``jax.vmap`` over the solo step: each step, each case
    runs the JAX package's ``one_step`` expression op for op,
    ``scale*(op.neighbor_sum(u) - wsum*op._operand(u))``, then the source
    ``-2*pi*sin(2*pi*t*dt)*G - cos(2*pi*t*dt)*L(G)``, then ``u + dt*du``,
    with ``ops[0]`` as the bucket's prototype (:func:`check_bucket_ops`)
    and each case's own scale and dt.  With the ``cuda`` method that is one
    ``nsum2d``/``nsum3d`` launch per case per step.  ``U`` is never written.
    """
    check_bucket_ops(ops)
    op = ops[0]
    wsum = op.wsum
    scales = [case_scale(o) for o in ops]
    dts = [o.dt for o in ops]

    def one_step(u, t, scale, dt, g, lg):
        du = scale * (op.neighbor_sum(u) - wsum * op._operand(u))
        if test:
            ang = TWO_PI * (t * dt)
            du = du + (-TWO_PI * math.sin(ang) * g - math.cos(ang) * lg)
        return u + dt * du

    src = _Sources(torch.stack([torch.as_tensor(g) for g in gs]),
                   torch.stack([torch.as_tensor(lg) for lg in lgs])) if test else None

    def multi(U, t0):
        U = U.to(dtype or U.dtype)
        gd, lgd = src.on(U) if test else ([None] * len(ops),) * 2
        lanes = list(U.unbind(0))
        for t in range(t0, t0 + nsteps):
            lanes = [one_step(u, t, scales[b], dts[b], gd[b], lgd[b])
                     for b, u in enumerate(lanes)]
        return torch.stack(lanes)

    return multi


def make_batched_multi_step_fn_stacked(ops, nsteps: int, dtype=None, test: bool = False,
                                       gs=None, lgs=None):
    """``multi(U, t0) -> U`` after ``nsteps`` steps: each case's solo
    per-step loop (:func:`make_multi_step_fn_base`, its own source), in
    turn, the results stacked.  The bit-exact reference composition: lane b
    is the solo solve of case b.  ``U`` is never written."""
    check_bucket_ops(ops)
    inner = [make_multi_step_fn_base(op, nsteps, gs[i] if test else None,
                                     lgs[i] if test else None, dtype)
             for i, op in enumerate(ops)]

    def multi(U, t0):
        return torch.stack([m(U[i], t0) for i, m in enumerate(inner)])

    return multi
