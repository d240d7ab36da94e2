"""The 3D kernels of the port: wrappers, plain versions, makers and the
resident kernel's gate.

Counterpart of the 3D part of ``nonlocalheatequation_tpu/ops/pallas_kernel.py``.
Three hand-written CUDA kernels (csrc/) replace three Pallas kernels; all
add in the order of the tile body of csrc/stencil_tile3d.cuh, which
nsum3d/step3d, carried3d and resident3d run above eps 6 (below, the
register design of the same header, fast3_sums, which gives the same bits):

* :func:`nsum3d` replaces ``build_neighbor_sum_3d`` (pallas_kernel.py:793):
  the masked-sphere neighbour sum of a halo-padded ``(nx+2e, ny+2e, nz+2e)``
  block, returning ``(nx, ny, nz)``.  :func:`step3d`, in the same source,
  fuses that sum with the Euler epilogue that XLA fuses outside the TPU
  kernel: ``u + dt*(scale*(nsum - wsum*u))``, and in the test form
  ``u + dt*((scale*(nsum - wsum*u)) + (coef_g*G + coef_lg*L(G)))``, the order
  of the JAX package's generic step.  It reads the UNPADDED state (zeros
  outside the domain).
* :func:`carried3d` replaces ``_build_carried_kernel_3d`` (:1507): one step
  of the state kept in a halo-padded frame; the kernel writes the interior,
  and the frame it writes keeps a zero halo.
* :func:`resident3d` replaces ``_build_resident_kernel_3d`` (:1419): the
  whole run in one cooperative launch, the state ping-ponging between two
  frames kept in L2 (``cuda_kernel.resident_frame``: the z axis padded to 16
  bytes, so that every window is staged by 16-byte copies through L2).

The multi-step kernels take the production (source-free) step, have no bf16
tier (as on the TPU) and are bit-identical to the same number of ``step3d``
launches.  Their makers ``make_carried_multi_step_fn_3d`` and
``make_resident_multi_step_fn_3d`` and the gate ``fits_resident_3d`` keep
the JAX package's names.

As in ops/cuda_kernel.py (which holds the launch counts and the C entry
points): a CPU tensor goes to the plain version beside each wrapper (plain
PyTorch that sums the sphere in the tile body's order,
``cuda_kernel.sphere_sum``, so that the kernels give its bits; for a
multi-step kernel, the per-step plain loop in the kernel's frame
bookkeeping); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nonlocalheatequation_torch.ops.constants import validate_precision
from nonlocalheatequation_torch.ops.cuda_kernel import (
    _DTYPE_CODE,
    LAUNCHES,
    _buffer,
    _check_device,
    _check_state,
    _entry,
    _raise_on,
    _reject_bf16_variant,
    _zero_halo,
    bf16_round,
    resident_frame,
    source_coefs,
    sphere_sum,
)

_REMEDY = "use method='shift' or 'sat' for this horizon"
_NO_BF16 = "the per-step 3D path"


def _pad3(x: torch.Tensor, e: int) -> torch.Tensor:
    return F.pad(x, (e,) * 6)


def _interior(frame: torch.Tensor, e: int) -> torch.Tensor:
    nx, ny, nz = (s - 2 * e for s in frame.shape)
    return frame[e:e + nx, e:e + ny, e:e + nz]


# -- plain versions -----------------------------------------------------------

def nsum3d_plain(upad: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """Neighbour sum of a halo-padded block (:func:`sphere_sum`)."""
    if precision == "bf16":
        upad = bf16_round(upad)
    return sphere_sum(upad, eps)


def _euler3_plain(opnd, carry, eps, scale, wsum, dt, *, g=None, lg=None, t=0):
    """carry + dt*(scale*(nsum(opnd) - wsum*opnd) [+ (coef_g*G + coef_lg*L(G))])
    with zero extension, one rounding per operation, in the tile body's
    order (csrc/nsum3d.cu)."""
    e = int(eps)
    du = scale * (nsum3d_plain(_pad3(opnd, e), e) - wsum * opnd)
    if g is not None:
        coef_g, coef_lg = source_coefs(t, dt)
        du = du + (coef_g * g + coef_lg * lg)
    return carry + dt * du


def step3d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
                 g: torch.Tensor | None = None, lg: torch.Tensor | None = None,
                 t: int = 0, precision: str = "f32") -> torch.Tensor:
    """One forward-Euler step with zero extension outside the domain."""
    opnd = bf16_round(u) if precision == "bf16" else u
    return _euler3_plain(opnd, u, eps, scale, wsum, dt, g=g, lg=lg, t=t)


def carried3d_plain(frame: torch.Tensor, eps: int, scale: float, wsum: float,
                    dt: float) -> torch.Tensor:
    """One production step of the halo-padded frame: the next frame, its
    halo zero."""
    e = int(eps)
    inner = _interior(frame, e)
    return _pad3(_euler3_plain(inner, inner, e, scale, wsum, dt), e)


def resident3d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                     nsteps: int) -> torch.Tensor:
    """``nsteps`` production steps, the state kept in a zero-halo frame."""
    e = int(eps)
    frame = _pad3(u, e)
    for _ in range(int(nsteps)):
        frame = carried3d_plain(frame, e, scale, wsum, dt)
    return _interior(frame, e).contiguous()


# -- kernel wrappers --------------------------------------------------------------

def nsum3d(upad: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """(nx+2e, ny+2e, nz+2e) halo-padded block -> (nx, ny, nz) masked-sphere
    neighbour sum.  ``precision="bf16"`` rounds the operand to bfloat16 at
    the load and accumulates in the block's dtype."""
    eps = int(eps)
    validate_precision(precision)
    if upad.dim() != 3 or min(upad.shape) < 2 * eps:
        raise ValueError(f"nsum3d: padded block {tuple(upad.shape)} too small for eps={eps}")
    if upad.device.type == "cpu":
        return nsum3d_plain(upad, eps, precision)
    nx, ny, nz = (s - 2 * eps for s in upad.shape)
    _check_state("nsum3d upad", upad, upad.shape)
    _check_device(upad)
    out = torch.empty((nx, ny, nz), dtype=upad.dtype, device=upad.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(upad.device):
        rc = _entry("nlheat_nsum3d")(
            _DTYPE_CODE[upad.dtype], int(precision == "bf16"), upad.data_ptr(),
            out.data_ptr(), nx, ny, nz, eps, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nsum3d", eps, upad, _REMEDY)
    LAUNCHES["nsum3d"] += 1
    return out


def step3d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
           g: torch.Tensor | None = None, lg: torch.Tensor | None = None, t: int = 0,
           precision: str = "f32", out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused forward-Euler step of the unpadded state ``u`` (nx, ny, nz),
    with the test source when ``g``/``lg`` are given (``t`` is the integer
    step).  ``out`` is an optional preallocated buffer that must not overlap
    ``u``."""
    eps = int(eps)
    validate_precision(precision)
    if (g is None) != (lg is None):
        raise ValueError("step3d: pass both g and lg (test form) or neither")
    if u.dim() != 3:
        raise ValueError(f"step3d: state must be 3D, got shape {tuple(u.shape)}")
    if u.device.type == "cpu":
        nxt = step3d_plain(u, eps, scale, wsum, dt, g=g, lg=lg, t=t, precision=precision)
        return nxt if out is None else out.copy_(nxt)
    _check_state("step3d u", u, u.shape)
    _check_device(u)
    if g is not None:
        _check_state("step3d g", g, u.shape, like=u)
        _check_state("step3d lg", lg, u.shape, like=u)
        coef_g, coef_lg = source_coefs(t, dt)
    else:
        coef_g = coef_lg = 0.0
    out = _buffer("step3d out", out, u, u.dtype, (u,))
    if u.numel() == 0:
        return out
    nx, ny, nz = u.shape
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_step3d")(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), u.data_ptr(), out.data_ptr(),
            None if g is None else g.data_ptr(), None if lg is None else lg.data_ptr(),
            nx, ny, nz, eps, float(scale), float(wsum), float(dt), coef_g, coef_lg,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "step3d", eps, u, _REMEDY)
    LAUNCHES["step3d"] += 1
    return out


def carried3d(frame: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One production step of the state kept in a halo-padded
    ``(nx+2e, ny+2e, nz+2e)`` frame: returns the next frame, its halo zero.
    ``out`` is an optional buffer that must not overlap ``frame``; its halo
    is zeroed here."""
    eps = int(eps)
    if frame.dim() != 3 or min(frame.shape) < 2 * eps:
        raise ValueError(f"carried3d: frame {tuple(frame.shape)} too small for eps={eps}")
    if frame.device.type != "cpu":
        out = (torch.zeros_like(frame) if out is None else _zero_halo(
            _buffer("carried3d out", out, frame, frame.dtype, (frame,)), eps, 3))
    return _carried3d(frame, out, eps, scale, wsum, dt)


def _carried3d(frame, out, eps: int, scale: float, wsum: float, dt: float) -> torch.Tensor:
    """:func:`carried3d` into ``out``, whose halo must already be zero: the
    kernel writes the interior only (csrc/carried3d.cu).  The multi-step
    maker's two frames, made with zero halos, keep them."""
    if frame.device.type == "cpu":
        res = carried3d_plain(frame, eps, scale, wsum, dt)
        return res if out is None else out.copy_(res)
    _check_state("carried3d frame", frame, frame.shape)
    _check_device(frame)
    nx, ny, nz = (s - 2 * eps for s in frame.shape)
    if min(nx, ny, nz) <= 0:  # no interior: the next frame is all halo
        return out.zero_()
    with torch.cuda.device(frame.device):
        rc = _entry("nlheat_carried3d")(
            _DTYPE_CODE[frame.dtype], frame.data_ptr(), out.data_ptr(), nx, ny, nz, eps,
            float(scale), float(wsum), float(dt), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "carried3d", eps, frame, _REMEDY)
    LAUNCHES["carried3d"] += 1
    return out


def resident3d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
               nsteps: int) -> torch.Tensor:
    """All ``nsteps`` production steps of the unpadded state ``u`` in one
    cooperative launch; returns the new (nx, ny, nz) state.  A grid beyond
    the card's gate (:func:`fits_resident_3d`) raises a ``ValueError``
    naming the resident 3D kernel, before anything is allocated or
    launched."""
    eps, nsteps = int(eps), int(nsteps)
    if u.dim() != 3:
        raise ValueError(f"resident3d: state must be 3D, got shape {tuple(u.shape)}")
    if nsteps < 0:
        raise ValueError(f"resident3d: nsteps must be >= 0, got {nsteps}")
    if u.device.type == "cpu":
        return resident3d_plain(u, eps, scale, wsum, dt, nsteps)
    _check_state("resident3d u", u, u.shape)
    _check_device(u)
    if nsteps == 0 or u.numel() == 0:
        return u.clone()
    nx, ny, nz = u.shape
    if not fits_resident_3d(nx, ny, nz, eps, u.dtype, u.device):
        raise ValueError(
            f"resident 3D kernel: {nx}x{ny}x{nz} eps={eps} {u.dtype} does not fit this card "
            "(its blocks co-resident, its two frames within the L2: csrc/resident3d.cu); "
            "use the per-step path")
    fa = resident_frame(u, eps)
    fb = torch.zeros_like(fa)
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_resident3d")(
            _DTYPE_CODE[u.dtype], fa.data_ptr(), fb.data_ptr(), nx, ny, nz, fa.shape[2], eps,
            nsteps, float(scale), float(wsum), float(dt),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "resident3d", eps, u, _REMEDY)
    LAUNCHES["resident3d"] += 1
    return (fb if nsteps % 2 else fa)[eps:eps + nx, eps:eps + ny, eps:eps + nz].contiguous()


# -- gates and makers (the JAX package's names) -----------------------------------

def tile3d(eps: int, dtype=torch.float32, device="cuda") -> int:
    """The plane width (8, 4, 2 or 1) of the 3D tile body's output tiles for
    this eps and dtype on ``device``, as csrc/stencil_tile3d.cuh chooses it
    from the card's shared memory (the tiles of every 3D kernel above eps
    6); 0 when the kernels refuse eps."""
    device = torch.device(device)
    if device.type != "cuda" or dtype not in _DTYPE_CODE:
        raise ValueError(f"tile3d: the tile is the card's, for float32/float64 on a CUDA "
                         f"device, not {dtype} on {device}")
    with torch.cuda.device(device):
        return _entry("nlheat_tile3d")(_DTYPE_CODE[dtype], int(eps))


def fits_resident_3d(nx: int, ny: int, nz: int, eps: int, dtype=torch.float32,
                     device="cuda") -> bool:
    """Whether the whole-run 3D kernel takes this grid on ``device``: on the
    card, the answer of csrc/resident3d.cu (its blocks co-resident, its two
    frames within the L2); on the CPU always, since the plain version has no
    such limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if dtype not in _DTYPE_CODE:
        return False
    with torch.cuda.device(device):
        return _entry("nlheat_resident3d_fits")(
            _DTYPE_CODE[dtype], int(nx), int(ny), int(nz), int(eps)) > 0


def _production_args(op) -> tuple:
    """(eps, scale, wsum, dt) of a 3D operator's production step; scale is
    c*h^3 as nonlocal_op.case_scale computes it (``op.c * op.dh**3``)."""
    return int(op.eps), op.c * op.dh**3, op.wsum, op.dt


def make_carried_multi_step_fn_3d(op, nsteps: int, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps, the state
    carried in a halo-padded frame: one ``carried3d`` launch per step, into
    two frames used in turn, whose halos stay the zeros they were made with.
    No bf16 tier: a bf16-tier operator is refused
    here.  ``t0`` is accepted for signature parity; ``u`` is never written."""
    _reject_bf16_variant(op, "carried 3D kernel", _NO_BF16)
    eps, scale, wsum, dt = _production_args(op)

    def multi(u, t0):
        del t0
        frame = _pad3(u.to(dtype or u.dtype), eps).contiguous()
        spare = torch.zeros_like(frame)
        for _ in range(nsteps):
            nxt = _carried3d(frame, spare, eps, scale, wsum, dt)
            spare, frame = frame, nxt
        return _interior(frame, eps).contiguous()

    return multi


def make_resident_multi_step_fn_3d(op, nsteps: int, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps in one
    ``resident3d`` launch.  No bf16 tier: a bf16-tier operator is refused
    here; a grid beyond the card's gate raises when the run is called."""
    _reject_bf16_variant(op, "resident 3D kernel", _NO_BF16)
    eps, scale, wsum, dt = _production_args(op)

    def multi(u, t0):
        del t0
        return resident3d(u.to(dtype or u.dtype).contiguous(), eps, scale, wsum, dt, nsteps)

    return multi
