"""The 2D kernels of the port: wrappers, plain versions, makers and launch
counts.

Counterpart of ``nonlocalheatequation_tpu/ops/pallas_kernel.py`` for the
main path.  Five hand-written CUDA kernels (csrc/, all on the tile body of
csrc/stencil_tile.cuh) replace five Pallas kernels:

* :func:`nsum2d` replaces ``build_neighbor_sum_2d`` (pallas_kernel.py:468):
  the masked-circle neighbour sum of a halo-padded ``(nx+2e, ny+2e)``
  block, returning ``(nx, ny)``.
* :func:`step2d` replaces ``_build_step_kernel`` (pallas_kernel.py:515, via
  ``make_pallas_step_fn`` :1601): one fused forward-Euler step
  ``u + dt*(scale*(nsum - wsum*u) [+ b_t])`` on the UNPADDED state (the
  kernel reads out-of-domain cells as 0), with the manufactured source
  ``b_t = coef_g*G + coef_lg*L(G)`` whose coefficients the wrapper computes
  on the host from the integer step.
* :func:`carried2d` replaces ``_build_carried_kernel`` (:856): one step of
  the state kept in a halo-padded frame, the halo re-zeroed by the kernel;
  in the bf16 tier the frame is the pair (master, bf16 shadow).
* :func:`superstep2d` replaces ``_build_superstep_kernel`` (:1032): K steps
  per launch by trapezoidal temporal blocking.
* :func:`resident2d` replaces ``_build_resident_kernel`` (:1292): the whole
  run in one cooperative launch, the state ping-ponging between two frames.

The multi-step kernels take the production (source-free) step and are
bit-identical to the same number of ``step2d`` launches.  Their makers
``make_carried_multi_step_fn``, ``make_superstep_multi_step_fn`` and
``make_resident_multi_step_fn``, and the gates ``fits_superstep``,
``fits_resident`` and ``superstep_k``, keep the JAX package's names.

Each wrapper checks its arguments, allocates its output with
``torch.empty`` (or writes into a caller's buffer), launches on the current
stream, raises on a non-zero launch status and counts the launch in
:data:`LAUNCHES`.  A CPU tensor goes to the plain version beside it (plain
PyTorch: shifted slice-adds over the mask, as the reference package's
``_neighbor_sum_shift``; for a multi-step kernel, the per-step plain loop in
the kernel's frame bookkeeping); a CUDA tensor launches the kernel or
raises.  The plain versions are what the CPU tests hold against the JAX
package and what ``chip_smoke.py`` holds the kernels against on the card.
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

#: kernel name -> launches since the last reset_launch_counts() (the 3D
#: kernels' wrappers live in ops/cuda_kernel3d.py, the batched 2D kernels'
#: in ops/cuda_batched.py, the unstructured kernels' in
#: ops/cuda_unstructured.py, the split halo kernels' in ops/cuda_halo.py)
LAUNCHES = {"nsum2d": 0, "step2d": 0, "carried2d": 0, "superstep2d": 0, "resident2d": 0,
            "nsum3d": 0, "step3d": 0, "carried3d": 0, "resident3d": 0,
            "batched_step2d": 0, "batched_carried2d": 0, "batched_superstep2d": 0,
            "windowed_matvec": 0, "gather_L": 0, "split_nsum2d": 0, "split_nsum3d": 0,
            "fused_nsum2d": 0, "fused_nsum3d": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: C entry point -> (source in csrc/, argument types); each returns an int
_ENTRIES = {
    "nlheat_nsum2d": ("nsum2d.cu", [_I, _I, _P, _P, _I, _I, _I, _P]),
    "nlheat_step2d": ("nsum2d.cu", [_I, _I, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _D, _D,
                                    _P]),
    "nlheat_carried2d": ("carried2d.cu", [_I, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _P]),
    "nlheat_superstep2d": ("superstep2d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _D, _D, _D,
                                              _P]),
    "nlheat_superstep2d_fits": ("superstep2d.cu", [_I, _I, _I, _I]),
    "nlheat_resident2d": ("resident2d.cu", [_I, _P, _P, _I, _I, _I, _I, _D, _D, _D, _P]),
    "nlheat_resident2d_fits": ("resident2d.cu", [_I, _I, _I, _I]),
    "nlheat_nsum3d": ("nsum3d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _P]),
    "nlheat_step3d": ("nsum3d.cu", [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _D,
                                    _D, _P]),
    "nlheat_tile3d": ("nsum3d.cu", [_I, _I]),
    "nlheat_carried3d": ("carried3d.cu", [_I, _P, _P, _I, _I, _I, _I, _D, _D, _D, _P]),
    "nlheat_resident3d": ("resident3d.cu", [_I, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _P]),
    "nlheat_resident3d_fits": ("resident3d.cu", [_I, _I, _I, _I, _I]),
    "nlheat_batched_step2d": ("batched_step2d.cu", [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                                    _I, _I, _D, _P]),
    "nlheat_batched_carried2d": ("batched_carried2d.cu", [_I, _P, _P, _P, _P, _P, _I, _I, _I,
                                                          _I, _D, _P]),
    "nlheat_batched_superstep2d": ("batched_superstep2d.cu", [_I, _I, _P, _P, _P, _I, _I, _I,
                                                              _I, _I, _D, _P]),
    "nlheat_batched_superstep2d_fits": ("batched_superstep2d.cu", [_I, _I, _I, _I]),
    "nlheat_windowed_matvec": ("windowed_matvec.cu", [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                                      _I, _P]),
    "nlheat_gather_L": ("gather_L.cu", [_I, _I, _P, _P, _P, _P, _P, _I, _P]),
    "nlheat_split_nsum2d": ("split_nsum2d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _P]),
    "nlheat_split_nsum3d": ("split_nsum3d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _I, _P]),
    "nlheat_fused_nsum2d": ("fused_nsum2d.cu", [_I, _I, _P, _I, _I, _P, _I, _I, _I, _P]),
    "nlheat_fused_nsum3d": ("fused_nsum3d.cu", [_I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                                                _P]),
    "nlheat_enable_peer": ("fused_nsum2d.cu", [_I, _I]),
}
_entries: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _entry(name: str):
    """The C entry point ``name``; its library is built and loaded at first use."""
    fn = _entries.get(name)
    if fn is None:
        source, argtypes = _ENTRIES[name]
        fn = getattr(_build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def source_coefs(t: int, dt: float) -> tuple:
    """(coef_g, coef_lg) of b_t = -2*pi*sin(2*pi*t*dt)*G - cos(2*pi*t*dt)*L(G),
    computed on the host in float64."""
    ang = TWO_PI * (t * dt)
    return -TWO_PI * math.sin(ang), -math.cos(ang)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 storage rounding, upcast back to the accumulate dtype."""
    return shadow_of(x).to(x.dtype)


def shadow_of(x: torch.Tensor) -> torch.Tensor:
    """The bfloat16 rounding of a state, as the kernels round: through
    float32, to nearest even."""
    return x.to(torch.float32).to(torch.bfloat16)


# -- plain versions -----------------------------------------------------------

def disc_sum(upad: torch.Tensor, eps: int) -> torch.Tensor:
    """The masked-disc sum of the halo-padded ``(..., nx+2e, ny+2e)`` block(s)
    in the tile body's order (csrc/stencil_tile.cuh), so that the kernels
    give its bits: every window row's column sums ``W_h = (W_{h-1} +
    row[-h]) + row[+h]`` grow one pair of columns per height, and each
    output adds ``W_{h_i}`` of its x offsets i, heights ascending, then i
    ascending, from 0."""
    e = int(eps)
    nx, ny = upad.shape[-2] - 2 * e, upad.shape[-1] - 2 * e
    acc = torch.zeros((*upad.shape[:-2], nx, ny), dtype=upad.dtype, device=upad.device)
    heights = [int(h) for h in column_half_heights(e)]
    W = upad[..., e:e + ny]
    for h in range(e + 1):
        if h:
            W = (W + upad[..., e - h:e - h + ny]) + upad[..., e + h:e + h + ny]
        for i in range(2 * e + 1):
            if heights[i] == h:
                acc = acc + W[..., i:i + nx, :]
    return acc


def nsum2d_plain(upad: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """Neighbour sum of a halo-padded block (:func:`disc_sum`)."""
    if precision == "bf16":
        upad = bf16_round(upad)
    return disc_sum(upad, eps)


def step2d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
                 g: torch.Tensor | None = None, lg: torch.Tensor | None = None,
                 t: int = 0, precision: str = "f32") -> torch.Tensor:
    """One forward-Euler step with zero extension outside the domain, in the
    kernel's arithmetic order."""
    opnd = bf16_round(u) if precision == "bf16" else u
    return _euler_plain(opnd, u, eps, scale, wsum, dt, g=g, lg=lg, t=t)


def _euler_plain(opnd, carry, eps, scale, wsum, dt, *, g=None, lg=None, t=0):
    """carry + dt*(scale*(nsum(opnd) - wsum*opnd) [+ b_t]) with zero extension:
    the tile body's epilogue (csrc/stencil_tile.cuh), one rounding per
    operation."""
    e = int(eps)
    acc = nsum2d_plain(F.pad(opnd, (e, e, e, e)), e)
    du = scale * (acc - wsum * opnd)
    if g is not None:
        coef_g, coef_lg = source_coefs(t, dt)
        du = du + coef_g * g
        du = du + coef_lg * lg
    return carry + dt * du


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


def _raise_on(rc: int, what: str, eps: int, x: torch.Tensor,
              remedy: str = "use method='conv' for this horizon"):
    """Turn a C entry point's status into an exception: -1 is the kernel
    library's refusal (eps, the shared-memory tile or the grid beyond its
    limits, which its source in csrc/ alone decides), anything else non-zero
    is cudaGetLastError()."""
    if rc == -1:
        raise ValueError(
            f"{what}: eps={eps} on a {tuple(x.shape)} {x.dtype} tensor is beyond what "
            f"the kernel takes (its eps, shared-memory or grid limit, "
            f"csrc/{_ENTRIES['nlheat_' + what][0]}); {remedy}")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError {rc}")


def _buffer(name: str, buf: torch.Tensor | None, like: torch.Tensor, dtype, inputs):
    """``buf`` checked (shape, dtype, device, contiguity, no overlap with
    ``inputs``), or a new ``torch.empty`` buffer."""
    if buf is None:
        return torch.empty(like.shape, dtype=dtype, device=like.device)
    if (tuple(buf.shape) != tuple(like.shape) or buf.dtype != dtype
            or buf.device != like.device or not buf.is_contiguous()):
        raise ValueError(f"{name}: needs a contiguous {tuple(like.shape)} {dtype} buffer on "
                         f"{like.device}, got {tuple(buf.shape)} {buf.dtype} on {buf.device}")
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel() * buf.element_size()
    for x in inputs:
        if x is not None and x.numel() and lo < x.data_ptr() + x.numel() * x.element_size() \
                and x.data_ptr() < hi:
            raise ValueError(f"{name} overlaps an input (the step reads neighbours of "
                             "every point it writes)")
    return buf


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
        rc = _entry("nlheat_nsum2d")(
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
    out = _buffer("step2d out", out, u, u.dtype, (u,))
    if u.numel() == 0:
        return out
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_step2d")(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), u.data_ptr(), out.data_ptr(),
            None if g is None else g.data_ptr(), None if lg is None else lg.data_ptr(),
            nx, ny, eps, float(scale), float(wsum), float(dt), coef_g, coef_lg,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "step2d", eps, u)
    LAUNCHES["step2d"] += 1
    return out


# -- multi-step kernels: plain versions -------------------------------------------

def carried2d_plain(frame: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                    shadow: torch.Tensor | None = None):
    """One production step of the halo-padded frame: the next frame with a
    zero halo, and with ``shadow`` (the bf16 tier) the pair (next frame, its
    bf16 shadow).  The window reads the shadow, the carry the frame."""
    e = int(eps)
    nx, ny = frame.shape[0] - 2 * e, frame.shape[1] - 2 * e
    master = frame[e:e + nx, e:e + ny]
    opnd = master if shadow is None else shadow[e:e + nx, e:e + ny].to(frame.dtype)
    nxt = F.pad(_euler_plain(opnd, master, e, scale, wsum, dt), (e, e, e, e))
    return nxt if shadow is None else (nxt, shadow_of(nxt))


def superstep2d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                      ksteps: int, precision: str = "f32") -> torch.Tensor:
    """``ksteps`` production steps of the unpadded state, one plain step each."""
    for _ in range(int(ksteps)):
        u = step2d_plain(u, eps, scale, wsum, dt, precision=precision)
    return u


def resident2d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                     nsteps: int) -> torch.Tensor:
    """``nsteps`` production steps, the state kept in a zero-halo frame."""
    e = int(eps)
    nx, ny = u.shape
    frame = F.pad(u, (e, e, e, e))
    for _ in range(int(nsteps)):
        inner = frame[e:e + nx, e:e + ny]
        frame = F.pad(_euler_plain(inner, inner, e, scale, wsum, dt), (e, e, e, e))
    return frame[e:e + nx, e:e + ny].contiguous()


# -- multi-step kernels: wrappers -------------------------------------------------

def carried2d(frame: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
              shadow: torch.Tensor | None = None, out: torch.Tensor | None = None,
              out_shadow: torch.Tensor | None = None):
    """One production step of the state kept in a halo-padded
    ``(nx+2e, ny+2e)`` frame: returns the next frame, its halo zero.  With
    ``shadow`` (the frame's bf16 rounding, ``torch.bfloat16``) it runs the
    bf16 tier and returns the pair (next frame, next shadow).  ``out`` and
    ``out_shadow`` are optional buffers that must not overlap the inputs."""
    eps = int(eps)
    if frame.dim() != 2 or frame.shape[0] < 2 * eps or frame.shape[1] < 2 * eps:
        raise ValueError(f"carried2d: frame {tuple(frame.shape)} too small for eps={eps}")
    if shadow is not None and (shadow.dtype != torch.bfloat16
                               or tuple(shadow.shape) != tuple(frame.shape)):
        raise ValueError(f"carried2d: the shadow must be a {tuple(frame.shape)} bfloat16 "
                         f"frame, got {tuple(shadow.shape)} {shadow.dtype}")
    if frame.device.type == "cpu":
        res = carried2d_plain(frame, eps, scale, wsum, dt, shadow)
        if shadow is None:
            return res if out is None else out.copy_(res)
        return (res[0] if out is None else out.copy_(res[0]),
                res[1] if out_shadow is None else out_shadow.copy_(res[1]))
    _check_state("carried2d frame", frame, frame.shape)
    _check_device(frame)
    nx, ny = frame.shape[0] - 2 * eps, frame.shape[1] - 2 * eps
    ins = (frame, shadow)
    out = _buffer("carried2d out", out, frame, frame.dtype, ins)
    if shadow is not None:
        if shadow.device != frame.device or not shadow.is_contiguous():
            raise ValueError("carried2d: the shadow must be contiguous, on the frame's device")
        out_shadow = _buffer("carried2d out_shadow", out_shadow, frame, torch.bfloat16, ins)
    if nx <= 0 or ny <= 0:  # no interior: the next frame is all halo
        out.zero_()
        return out if shadow is None else (out, out_shadow.zero_())
    with torch.cuda.device(frame.device):
        rc = _entry("nlheat_carried2d")(
            _DTYPE_CODE[frame.dtype], frame.data_ptr(),
            None if shadow is None else shadow.data_ptr(), out.data_ptr(),
            None if shadow is None else out_shadow.data_ptr(), nx, ny, eps, float(scale),
            float(wsum), float(dt), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "carried2d", eps, frame)
    LAUNCHES["carried2d"] += 1
    return out if shadow is None else (out, out_shadow)


def superstep2d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                ksteps: int, precision: str = "f32",
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``ksteps`` production steps of the unpadded state ``u`` (nx, ny) in
    one launch, by trapezoidal temporal blocking (csrc/superstep2d.cu takes
    K up to 4).  ``out`` is an optional (nx, ny) buffer that must not
    overlap ``u``."""
    eps, ksteps = int(eps), int(ksteps)
    validate_precision(precision)
    if u.dim() != 2:
        raise ValueError(f"superstep2d: state must be 2D, got shape {tuple(u.shape)}")
    if ksteps < 1:
        raise ValueError(f"superstep2d: ksteps must be >= 1, got {ksteps}")
    if u.device.type == "cpu":
        nxt = superstep2d_plain(u, eps, scale, wsum, dt, ksteps, precision)
        return nxt if out is None else out.copy_(nxt)
    _check_state("superstep2d u", u, u.shape)
    _check_device(u)
    out = _buffer("superstep2d out", out, u, u.dtype, (u,))
    if u.numel() == 0:
        return out
    nx, ny = u.shape
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_superstep2d")(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), u.data_ptr(), out.data_ptr(), nx,
            ny, eps, ksteps, float(scale), float(wsum), float(dt),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "superstep2d", eps, u)
    LAUNCHES["superstep2d"] += 1
    return out


def resident2d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
               nsteps: int) -> torch.Tensor:
    """All ``nsteps`` production steps of the unpadded state ``u`` in one
    cooperative launch; returns the new (nx, ny) state.  A grid beyond the
    card's gate (:func:`fits_resident`) raises a ``ValueError`` naming the
    resident kernel, before anything is allocated or launched."""
    eps, nsteps = int(eps), int(nsteps)
    if u.dim() != 2:
        raise ValueError(f"resident2d: state must be 2D, got shape {tuple(u.shape)}")
    if nsteps < 0:
        raise ValueError(f"resident2d: nsteps must be >= 0, got {nsteps}")
    if u.device.type == "cpu":
        return resident2d_plain(u, eps, scale, wsum, dt, nsteps)
    _check_state("resident2d u", u, u.shape)
    _check_device(u)
    if nsteps == 0 or u.numel() == 0:
        return u.clone()
    nx, ny = u.shape
    if not fits_resident(nx, ny, eps, u.dtype, u.device):
        raise ValueError(
            f"resident kernel: {nx}x{ny} eps={eps} {u.dtype} does not fit this card (its "
            "blocks co-resident, its two frames within the L2: csrc/resident2d.cu); use "
            "the per-step path")
    fa = F.pad(u, (eps, eps, eps, eps)).contiguous()
    fb = torch.zeros_like(fa)
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_resident2d")(
            _DTYPE_CODE[u.dtype], fa.data_ptr(), fb.data_ptr(), nx, ny, eps, nsteps,
            float(scale), float(wsum), float(dt), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "resident2d", eps, u)
    LAUNCHES["resident2d"] += 1
    return (fb if nsteps % 2 else fa)[eps:eps + nx, eps:eps + ny].contiguous()


# -- gates and makers (the JAX package's names) -----------------------------------

def superstep_k(ksteps: int, nsteps: int) -> int:
    """The fused-step depth make_superstep_multi_step_fn runs: K never
    exceeds the step count (pallas_kernel.superstep_k)."""
    return max(1, min(int(ksteps), nsteps if nsteps else 1))


def fits_superstep(nx: int, ny: int, eps: int, ksteps: int, dtype=torch.float32,
                   precision: str = "f32", device="cuda") -> bool:
    """Whether the K-step kernel takes this grid on ``device``: on the card,
    the answer of csrc/superstep2d.cu (the widened window's shared memory,
    K <= 4); on the CPU always, since the plain version has no such limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if dtype not in _DTYPE_CODE:
        return False
    with torch.cuda.device(device):
        return _entry("nlheat_superstep2d_fits")(
            _DTYPE_CODE[dtype], int(precision == "bf16"), int(eps), int(ksteps)) > 0


def fits_resident(nx: int, ny: int, eps: int, dtype=torch.float32, device="cuda") -> bool:
    """Whether the whole-run kernel takes this grid on ``device``: on the
    card, the answer of csrc/resident2d.cu (its blocks co-resident, its two
    frames within the L2); on the CPU always, since the plain version has no
    such limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if dtype not in _DTYPE_CODE:
        return False
    with torch.cuda.device(device):
        return _entry("nlheat_resident2d_fits")(
            _DTYPE_CODE[dtype], int(nx), int(ny), int(eps)) > 0


def _production_args(op) -> tuple:
    """(eps, scale, wsum, dt) of a 2D operator's production step; scale is
    c*h^2 as nonlocal_op.case_scale computes it."""
    return int(op.eps), op.c * op.dh * op.dh, op.wsum, op.dt


def _reject_bf16_variant(op, what: str,
                        remedy: str = "the per-step, carried, or superstep 2D paths") -> None:
    """A variant without a bf16 tier refuses a bf16-tier operator: running
    the f32 function instead would break the tier's rule that every variant
    computes the same rounded-operand result."""
    if getattr(op, "precision", "f32") == "bf16":
        raise ValueError(f"the {what} has no bf16 precision tier; use {remedy} "
                         "(or precision='f32')")


def make_carried_multi_step_fn(op, nsteps: int, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps, the state
    carried in a halo-padded frame: one ``carried2d`` launch per step, into
    two frames (pairs in the bf16 tier) used in turn.  ``t0`` is accepted
    for signature parity (the production step does not depend on time);
    ``u`` is never written."""
    eps, scale, wsum, dt = _production_args(op)
    bf16 = op.precision == "bf16"

    def multi(u, t0):
        del t0
        u = u.to(dtype or u.dtype)
        nx, ny = u.shape
        frame = F.pad(u, (eps, eps, eps, eps)).contiguous()
        shadow = shadow_of(frame) if bf16 else None
        spare = spare_shadow = None
        for _ in range(nsteps):
            if bf16:
                nxt, nxt_shadow = carried2d(frame, eps, scale, wsum, dt, shadow=shadow,
                                            out=spare, out_shadow=spare_shadow)
            else:
                nxt, nxt_shadow = carried2d(frame, eps, scale, wsum, dt, out=spare), None
            spare, spare_shadow, frame, shadow = frame, shadow, nxt, nxt_shadow
        return frame[eps:eps + nx, eps:eps + ny].contiguous()

    return multi


def make_superstep_multi_step_fn(op, nsteps: int, ksteps: int = 2, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps, ``ksteps``
    per ``superstep2d`` launch; the remainder ``nsteps % K`` runs as one
    shallower launch.  ``u`` is never written."""
    eps, scale, wsum, dt = _production_args(op)
    K = superstep_k(ksteps, nsteps)
    q, r = divmod(nsteps, K)
    depths = [K] * q + ([r] if r else [])

    def multi(u, t0):
        del t0
        cur = u.to(dtype=dtype or u.dtype, memory_format=torch.contiguous_format, copy=True)
        spare = torch.empty_like(cur)
        for k in depths:
            nxt = superstep2d(cur, eps, scale, wsum, dt, k, op.precision, out=spare)
            spare, cur = cur, nxt
        return cur

    return multi


def make_resident_multi_step_fn(op, nsteps: int, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps in one
    ``resident2d`` launch.  No bf16 tier: a bf16-tier operator is refused
    here; a grid beyond the card's gate raises when the run is called."""
    _reject_bf16_variant(op, "resident kernel")
    eps, scale, wsum, dt = _production_args(op)

    def multi(u, t0):
        del t0
        return resident2d(u.to(dtype or u.dtype).contiguous(), eps, scale, wsum, dt, nsteps)

    return multi
