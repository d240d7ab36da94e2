"""The 2D kernels of the port: wrappers, plain versions and launch counts.

Counterpart of ``nonlocalheatequation_tpu/ops/pallas_kernel.py`` for the
main path.  Two hand-written CUDA kernels (csrc/nsum2d.cu) replace two
Pallas kernels:

* :func:`nsum2d` replaces ``build_neighbor_sum_2d`` (pallas_kernel.py:468):
  the masked-circle neighbour sum of a halo-padded ``(nx+2e, ny+2e)``
  block, returning ``(nx, ny)``.
* :func:`step2d` replaces ``_build_step_kernel`` (pallas_kernel.py:515, via
  ``make_pallas_step_fn`` :1601): one fused forward-Euler step
  ``u + dt*(scale*(nsum - wsum*u) [+ b_t])`` on the UNPADDED state (the
  kernel reads out-of-domain cells as 0), with the manufactured source
  ``b_t = coef_g*G + coef_lg*L(G)`` whose coefficients the wrapper computes
  on the host from the integer step.

Each wrapper checks its arguments, allocates its output with
``torch.empty`` (or writes into a caller's buffer), launches on the current
stream, raises on a non-zero launch status and counts the launch in
:data:`LAUNCHES`.  A CPU tensor goes to the plain version beside it (plain
PyTorch: shifted slice-adds over the mask, as the reference package's
``_neighbor_sum_shift``); a CUDA tensor launches the kernel or raises.
The plain versions are what the CPU tests hold against the JAX package and
what ``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from nonlocalheatequation_torch.ops import _build
from nonlocalheatequation_torch.ops.constants import validate_precision
from nonlocalheatequation_torch.ops.stencil import column_half_heights

TWO_PI = 2.0 * math.pi
SOURCE = "nsum2d.cu"

#: kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {"nsum2d": 0, "step2d": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.nlheat_nsum2d.argtypes = [i, i, p, p, i, i, i, p]
        lib.nlheat_nsum2d.restype = i
        lib.nlheat_step2d.argtypes = [i, i, p, p, p, p, i, i, i, d, d, d, d, d, p]
        lib.nlheat_step2d.restype = i
        _lib = lib
    return _lib


def source_coefs(t: int, dt: float) -> tuple:
    """(coef_g, coef_lg) of b_t = -2*pi*sin(2*pi*t*dt)*G - cos(2*pi*t*dt)*L(G),
    computed on the host in float64."""
    ang = TWO_PI * (t * dt)
    return -TWO_PI * math.sin(ang), -math.cos(ang)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 storage rounding, upcast back to the accumulate dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


# -- plain versions -----------------------------------------------------------

def nsum2d_plain(upad: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """Neighbour sum of a halo-padded block by one slice-add per mask offset."""
    e = int(eps)
    if precision == "bf16":
        upad = bf16_round(upad)
    nx, ny = upad.shape[0] - 2 * e, upad.shape[1] - 2 * e
    acc = torch.zeros((nx, ny), dtype=upad.dtype, device=upad.device)
    heights = column_half_heights(e)
    for i in range(2 * e + 1):
        h = int(heights[i])
        for j in range(e - h, e + h + 1):
            acc = acc + upad[i:i + nx, j:j + ny]
    return acc


def step2d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
                 g: torch.Tensor | None = None, lg: torch.Tensor | None = None,
                 t: int = 0, precision: str = "f32") -> torch.Tensor:
    """One forward-Euler step with zero extension outside the domain, in the
    kernel's arithmetic order."""
    e = int(eps)
    opnd = bf16_round(u) if precision == "bf16" else u
    acc = nsum2d_plain(F.pad(opnd, (e, e, e, e)), e)
    du = scale * (acc - wsum * opnd)
    if g is not None:
        coef_g, coef_lg = source_coefs(t, dt)
        du = du + coef_g * g
        du = du + coef_lg * lg
    return u + dt * du


# -- kernel wrappers ------------------------------------------------------------

def _check_state(name: str, x: torch.Tensor, shape, like: torch.Tensor | None = None):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, float64)")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if like is not None and (x.dtype != like.dtype or x.device != like.device):
        raise ValueError(f"{name}: {x.dtype} on {x.device} does not match "
                         f"{like.dtype} on {like.device}")


def _check_device(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {x.device}")


def _raise_on(rc: int, what: str, eps: int, x: torch.Tensor):
    """Turn a C entry point's status into an exception: -1 is the kernel
    library's refusal (eps, the shared-memory tile or the grid beyond its
    limits, which csrc/nsum2d.cu alone decides), anything else non-zero is
    cudaGetLastError()."""
    if rc == -1:
        raise ValueError(
            f"{what}: eps={eps} on a {tuple(x.shape)} {x.dtype} tensor is beyond what "
            "the kernel takes (its eps, shared-memory or grid limit, csrc/nsum2d.cu); "
            "use method='conv' for this horizon")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError {rc}")


def nsum2d(upad: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """(nx+2e, ny+2e) halo-padded block -> (nx, ny) masked-circle neighbour
    sum.  ``precision="bf16"`` rounds the operand to bfloat16 at the load
    and accumulates in the block's dtype."""
    eps = int(eps)
    validate_precision(precision)
    if upad.dim() != 2 or upad.shape[0] < 2 * eps or upad.shape[1] < 2 * eps:
        raise ValueError(f"nsum2d: padded block {tuple(upad.shape)} too small for eps={eps}")
    if upad.device.type == "cpu":
        return nsum2d_plain(upad, eps, precision)
    nx, ny = upad.shape[0] - 2 * eps, upad.shape[1] - 2 * eps
    _check_state("nsum2d upad", upad, upad.shape)
    _check_device(upad)
    out = torch.empty((nx, ny), dtype=upad.dtype, device=upad.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(upad.device):
        rc = _library().nlheat_nsum2d(
            _DTYPE_CODE[upad.dtype], int(precision == "bf16"), upad.data_ptr(),
            out.data_ptr(), nx, ny, eps, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nsum2d", eps, upad)
    LAUNCHES["nsum2d"] += 1
    return out


def step2d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
           g: torch.Tensor | None = None, lg: torch.Tensor | None = None, t: int = 0,
           precision: str = "f32", out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused forward-Euler step of the unpadded state ``u`` (nx, ny):
    ``u + dt*(scale*(nsum - wsum*u) + b_t)``, with the test source when
    ``g``/``lg`` are given (``t`` is the integer step).  ``out`` is an
    optional preallocated (nx, ny) buffer that must not overlap ``u``."""
    eps = int(eps)
    validate_precision(precision)
    if (g is None) != (lg is None):
        raise ValueError("step2d: pass both g and lg (test form) or neither")
    if u.dim() != 2:
        raise ValueError(f"step2d: state must be 2D, got shape {tuple(u.shape)}")
    if u.device.type == "cpu":
        nxt = step2d_plain(u, eps, scale, wsum, dt, g=g, lg=lg, t=t, precision=precision)
        return nxt if out is None else out.copy_(nxt)
    nx, ny = u.shape
    _check_state("step2d u", u, u.shape)
    _check_device(u)
    if g is not None:
        _check_state("step2d g", g, u.shape, like=u)
        _check_state("step2d lg", lg, u.shape, like=u)
        coef_g, coef_lg = source_coefs(t, dt)
    else:
        coef_g = coef_lg = 0.0
    if out is None:
        out = torch.empty_like(u)
    else:
        _check_state("step2d out", out, u.shape, like=u)
        if out.numel() and abs(out.data_ptr() - u.data_ptr()) < u.numel() * u.element_size():
            raise ValueError("step2d: out overlaps u (the step reads neighbours of "
                             "every point it writes)")
    if u.numel() == 0:
        return out
    with torch.cuda.device(u.device):
        rc = _library().nlheat_step2d(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), u.data_ptr(), out.data_ptr(),
            None if g is None else g.data_ptr(), None if lg is None else lg.data_ptr(),
            nx, ny, eps, float(scale), float(wsum), float(dt), coef_g, coef_lg,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "step2d", eps, u)
    LAUNCHES["step2d"] += 1
    return out
