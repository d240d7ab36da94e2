"""The batched 2D kernels of the port: wrappers, plain versions, makers and
the superstep gate, for the ensemble engine (serve/ensemble.py).

Counterpart of the batched section of
``nonlocalheatequation_tpu/ops/pallas_kernel.py``.  Three hand-written CUDA
kernels (csrc/, on csrc/stencil_tile.cuh: batched_step2d and
batched_carried2d on its register walk ``reg_tiles`` up to eps 16,
batched_superstep2d on its superstep levels up to eps 8, each on the tile
body above) advance a ``(B, nx, ny)`` stack of independent 2D solves that
share (shape, eps, dtype, precision tier) in one launch:

* :func:`batched_step2d` replaces ``_build_batched_step_kernel``
  (pallas_kernel.py:1694, via ``make_batched_pallas_multi_step_fn``
  :1765): one fused Euler step per case, production or test form;
* :func:`batched_carried2d` replaces ``_build_batched_carried_kernel``
  (:1839, ``make_batched_carried_multi_step_fn`` :1915): one step of a
  stack of halo-padded frames (the JAX package's bf16 tier carries a
  (master, shadow) pair; here the kernel rounds the master as it stages
  it, so no shadow stack is kept);
* :func:`batched_superstep2d` replaces ``_build_batched_superstep_kernel``
  (:1963, ``make_batched_superstep_multi_step_fn`` :2068): K = 1-4 steps
  per launch by trapezoidal temporal blocking.

Lane b of each is bit-identical to the solo kernel (``step2d``,
``carried2d``, ``superstep2d``) on case b; the solo ``step2d`` and
``carried2d`` (ops/cuda_kernel.py) are one-case launches of the first
two.  One difference from the JAX
package, on purpose: its batched kernels bake one (scale, dt) pair and
serve physics-uniform chunks only, running mixed chunks as per-case solo
programs; here each case reads its own (scale, dt) from a ``(B, 2)`` table
(:func:`case_params`), which the tile body's separately rounded epilogue
makes bit-exact, so one launch serves uniform and mixed chunks alike.  The
test form's per-step coefficients come from one ``(nsteps, B, 2)`` table
per run (:func:`source_coef_table`: ``source_coefs`` on the host in
float64, cast and copied once), so no step copies or waits.

As in ops/cuda_kernel.py (which holds the launch counts and the C entry
points): a CPU tensor goes to the plain version beside each wrapper (the
solo plain arithmetic over the case axis, one operation per tensor op); a
CUDA tensor launches the kernel or raises.
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
    _zero_halo,
    bf16_round,
    case_params,
    disc_sum,
    shadow_of,
    source_coef_table,
    superstep_k,
)


# -- plain versions -----------------------------------------------------------

def _euler_stack(opnd, carry, eps, params, wsum, G=None, LG=None, coefs=None):
    """carry + dt*(scale*(nsum(opnd) - wsum*opnd) [+ coef_g*G + coef_lg*L(G)])
    per case, each case's scalars from its row of ``params`` (``coefs``):
    the tile body's epilogue, one rounding per operation."""
    e = int(eps)
    acc = disc_sum(F.pad(opnd, (e, e, e, e)), e)
    du = params[:, 0, None, None] * (acc - wsum * opnd)
    if G is not None:
        du = du + coefs[:, 0, None, None] * G
        du = du + coefs[:, 1, None, None] * LG
    return carry + params[:, 1, None, None] * du


def batched_step2d_plain(U, eps, params, wsum, *, G=None, LG=None, coefs=None,
                         precision="f32") -> torch.Tensor:
    """One step of every case of the (B, nx, ny) stack, zeros outside."""
    opnd = bf16_round(U) if precision == "bf16" else U
    return _euler_stack(opnd, U, eps, params, wsum, G, LG, coefs)


def batched_carried2d_plain(frames, eps, params, wsum, shadow=None):
    """One production step of every frame of the (B, nx+2e, ny+2e) stack:
    the next stack with zero halos, and with ``shadow`` (the bf16 tier) the
    pair (next stack, its bf16 shadow)."""
    e = int(eps)
    nx, ny = frames.shape[1] - 2 * e, frames.shape[2] - 2 * e
    master = frames[:, e:e + nx, e:e + ny]
    opnd = master if shadow is None else shadow[:, e:e + nx, e:e + ny].to(frames.dtype)
    nxt = F.pad(_euler_stack(opnd, master, e, params, wsum), (e, e, e, e))
    return nxt if shadow is None else (nxt, shadow_of(nxt))


def batched_superstep2d_plain(U, eps, params, wsum, ksteps, precision="f32"):
    """``ksteps`` production steps of every case, one plain step each."""
    for _ in range(int(ksteps)):
        U = batched_step2d_plain(U, eps, params, wsum, precision=precision)
    return U


# -- kernel wrappers ------------------------------------------------------------

def _check_stack(name: str, x: torch.Tensor, eps: int, frame: bool = False):
    if x.dim() != 3:
        raise ValueError(f"{name}: a (B, nx, ny) case stack, got shape {tuple(x.shape)}")
    if frame and (x.shape[1] < 2 * eps or x.shape[2] < 2 * eps):
        raise ValueError(f"{name}: frames {tuple(x.shape[1:])} too small for eps={eps}")


def _check_table(name: str, t: torch.Tensor, batch: int, like: torch.Tensor):
    if tuple(t.shape) != (batch, 2) or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name}: needs a ({batch}, 2) {like.dtype} table on {like.device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous table")


def batched_step2d(U: torch.Tensor, eps: int, params: torch.Tensor, wsum: float, *,
                   G: torch.Tensor | None = None, LG: torch.Tensor | None = None,
                   coefs: torch.Tensor | None = None, precision: str = "f32",
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused forward-Euler step of every case of the unpadded (B, nx, ny)
    stack ``U``; case b uses row b of ``params`` (:func:`case_params`).  The
    test form takes the (B, nx, ny) stacks ``G``/``LG`` and the (B, 2) table
    ``coefs`` of this step's (coef_g, coef_lg).  ``out`` is an optional
    (B, nx, ny) buffer that must not overlap ``U``."""
    eps = int(eps)
    validate_precision(precision)
    if not ((G is None) == (LG is None) == (coefs is None)):
        raise ValueError("batched_step2d: pass G, LG and coefs (test form) or none")
    _check_stack("batched_step2d", U, eps)
    _check_table("batched_step2d params", params, U.shape[0], U)
    if coefs is not None:
        _check_table("batched_step2d coefs", coefs, U.shape[0], U)
    if U.device.type == "cpu":
        nxt = batched_step2d_plain(U, eps, params, wsum, G=G, LG=LG, coefs=coefs,
                                   precision=precision)
        return nxt if out is None else out.copy_(nxt)
    batch, nx, ny = U.shape
    _check_state("batched_step2d U", U, U.shape)
    _check_device(U)
    if G is not None:
        _check_state("batched_step2d G", G, U.shape, like=U)
        _check_state("batched_step2d LG", LG, U.shape, like=U)
    out = _buffer("batched_step2d out", out, U, U.dtype, (U,))
    if U.numel() == 0:
        return out
    with torch.cuda.device(U.device):
        rc = _entry("nlheat_batched_step2d")(
            _DTYPE_CODE[U.dtype], int(precision == "bf16"), U.data_ptr(), out.data_ptr(),
            None if G is None else G.data_ptr(), None if LG is None else LG.data_ptr(),
            None if coefs is None else coefs.data_ptr(), params.data_ptr(), batch, nx, ny,
            eps, float(wsum), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "batched_step2d", eps, U)
    LAUNCHES["batched_step2d"] += 1
    return out


def batched_carried2d(frames: torch.Tensor, eps: int, params: torch.Tensor, wsum: float,
                      precision: str = "f32", out: torch.Tensor | None = None) -> torch.Tensor:
    """One production step of every frame of the (B, nx+2e, ny+2e) stack:
    returns the next stack, its halos zero.  ``precision="bf16"`` runs the
    bf16 tier: the operand is the stack's :func:`shadow_of`, rounded from
    the masters as the window is staged.  ``out`` is an optional buffer that
    must not overlap ``frames``; its halos are zeroed here."""
    eps = int(eps)
    validate_precision(precision)
    _check_stack("batched_carried2d", frames, eps, frame=True)
    if frames.device.type != "cpu":
        out = (torch.zeros_like(frames) if out is None else _zero_halo(
            _buffer("batched_carried2d out", out, frames, frames.dtype, (frames,)), eps, 2))
    return _batched_carried2d(frames, out, eps, params, wsum, precision)


def _batched_carried2d(frames, out, eps: int, params, wsum: float, precision: str):
    """:func:`batched_carried2d` into ``out``, whose halos must already be
    zero: the kernel writes the interiors only (csrc/batched_carried2d.cu).
    The multi-step maker's two stacks, made with zero halos, keep them."""
    _check_table("batched_carried2d params", params, frames.shape[0], frames)
    if frames.device.type == "cpu":
        shadow = shadow_of(frames) if precision == "bf16" else None
        res = batched_carried2d_plain(frames, eps, params, wsum, shadow)
        res = res if shadow is None else res[0]
        return res if out is None else out.copy_(res)
    _check_state("batched_carried2d frames", frames, frames.shape)
    _check_device(frames)
    batch = frames.shape[0]
    nx, ny = frames.shape[1] - 2 * eps, frames.shape[2] - 2 * eps
    if nx <= 0 or ny <= 0:  # no interior: every next frame is all halo
        return out.zero_()
    with torch.cuda.device(frames.device):
        rc = _entry("nlheat_batched_carried2d")(
            _DTYPE_CODE[frames.dtype], int(precision == "bf16"), frames.data_ptr(),
            out.data_ptr(), params.data_ptr(), batch, nx, ny, eps, float(wsum),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "batched_carried2d", eps, frames)
    LAUNCHES["batched_carried2d"] += 1
    return out


def batched_superstep2d(U: torch.Tensor, eps: int, params: torch.Tensor, wsum: float,
                        ksteps: int, precision: str = "f32",
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """``ksteps`` production steps of every case of the unpadded (B, nx, ny)
    stack in one launch (csrc/batched_superstep2d.cu takes K up to 4).
    ``out`` is an optional buffer that must not overlap ``U``."""
    eps, ksteps = int(eps), int(ksteps)
    validate_precision(precision)
    _check_stack("batched_superstep2d", U, eps)
    _check_table("batched_superstep2d params", params, U.shape[0], U)
    if ksteps < 1:
        raise ValueError(f"batched_superstep2d: ksteps must be >= 1, got {ksteps}")
    if U.device.type == "cpu":
        nxt = batched_superstep2d_plain(U, eps, params, wsum, ksteps, precision)
        return nxt if out is None else out.copy_(nxt)
    _check_state("batched_superstep2d U", U, U.shape)
    _check_device(U)
    out = _buffer("batched_superstep2d out", out, U, U.dtype, (U,))
    if U.numel() == 0:
        return out
    batch, nx, ny = U.shape
    with torch.cuda.device(U.device):
        rc = _entry("nlheat_batched_superstep2d")(
            _DTYPE_CODE[U.dtype], int(precision == "bf16"), U.data_ptr(), out.data_ptr(),
            params.data_ptr(), batch, nx, ny, eps, ksteps, float(wsum),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "batched_superstep2d", eps, U)
    LAUNCHES["batched_superstep2d"] += 1
    return out


# -- the gate and the makers (the JAX package's names) -----------------------------

def fits_batched_superstep(eps: int, ksteps: int, dtype=torch.float32, precision: str = "f32",
                           device="cuda") -> bool:
    """Whether the batched K-step kernel takes this eps, K, dtype and tier on
    ``device``: on the card, the answer of csrc/batched_superstep2d.cu (the
    widened window's shared memory, K <= 4); on the CPU always."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if dtype not in _DTYPE_CODE:
        return False
    with torch.cuda.device(device):
        return _entry("nlheat_batched_superstep2d_fits")(
            _DTYPE_CODE[dtype], int(precision == "bf16"), int(eps), int(ksteps)) > 0


def _bucket(ops) -> tuple:
    """(eps, wsum, precision, scales, dts) of a batchable bucket of 2D
    operators."""
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        NonlocalOp2D,
        case_scale,
        check_bucket_ops,
    )

    check_bucket_ops(ops)
    if not isinstance(ops[0], NonlocalOp2D):
        raise ValueError(f"the batched kernels are 2D; got {type(ops[0]).__name__} (the "
                         "ensemble runs other ranks through the vmap composition)")
    return (int(ops[0].eps), ops[0].wsum, ops[0].precision,
            [case_scale(op) for op in ops], [op.dt for op in ops])


def make_batched_cuda_multi_step_fn(ops, nsteps: int, dtype=None, test: bool = False,
                                    gs=None, lgs=None):
    """``multi(U, t0) -> U`` after ``nsteps`` forward-Euler steps of every
    case of the (B, nx, ny) stack, B = len(ops): one ``batched_step2d``
    launch per step, into two buffers used in turn.  ``test=True`` adds the
    manufactured source; ``gs``/``lgs`` are the per-case (G, L(G)) (NumPy
    arrays or tensors).  ``U`` is never written."""
    from nonlocalheatequation_torch.ops.nonlocal_op import _Sources

    eps, wsum, precision, scales, dts = _bucket(ops)
    sources = _Sources(torch.stack([torch.as_tensor(g) for g in gs]),
                       torch.stack([torch.as_tensor(lg) for lg in lgs])) if test else None

    def multi(U, t0):
        cur = U.to(dtype=dtype or U.dtype, memory_format=torch.contiguous_format, copy=True)
        params = case_params(scales, dts, cur.dtype, cur.device)
        kw = {}
        if test:
            kw["G"], kw["LG"] = sources.on(cur)
            table = source_coef_table(range(t0, t0 + nsteps), dts, cur.dtype, cur.device)
        spare = torch.empty_like(cur)
        for i in range(nsteps):
            if test:
                kw["coefs"] = table[i]
            nxt = batched_step2d(cur, eps, params, wsum, precision=precision, out=spare, **kw)
            spare, cur = cur, nxt
        return cur

    return multi


def make_batched_carried_multi_step_fn(ops, nsteps: int, dtype=None):
    """``multi(U, t0) -> U`` after ``nsteps`` production steps, the stack
    carried in halo-padded frames: one ``batched_carried2d`` launch per step
    into two frame stacks used in turn, whose halos stay the zeros they were
    made with.  ``t0`` is accepted for signature parity; ``U`` is never
    written."""
    eps, wsum, precision, scales, dts = _bucket(ops)

    def multi(U, t0):
        del t0
        U = U.to(dtype or U.dtype)
        nx, ny = U.shape[1:]
        params = case_params(scales, dts, U.dtype, U.device)
        frames = F.pad(U, (eps, eps, eps, eps)).contiguous()
        spare = torch.zeros_like(frames)
        for _ in range(nsteps):
            nxt = _batched_carried2d(frames, spare, eps, params, wsum, precision)
            spare, frames = frames, nxt
        return frames[:, eps:eps + nx, eps:eps + ny].contiguous()

    return multi


def make_batched_superstep_multi_step_fn(ops, nsteps: int, ksteps: int = 2, dtype=None):
    """``multi(U, t0) -> U`` after ``nsteps`` production steps, ``ksteps``
    per ``batched_superstep2d`` launch; the remainder ``nsteps % K`` runs as
    one shallower launch (pallas_kernel.py:2110-2136).  ``U`` is never
    written."""
    eps, wsum, precision, scales, dts = _bucket(ops)
    K = superstep_k(ksteps, nsteps)
    q, r = divmod(nsteps, K)
    depths = [K] * q + ([r] if r else [])

    def multi(U, t0):
        del t0
        cur = U.to(dtype=dtype or U.dtype, memory_format=torch.contiguous_format, copy=True)
        params = case_params(scales, dts, cur.dtype, cur.device)
        spare = torch.empty_like(cur)
        for k in depths:
            nxt = batched_superstep2d(cur, eps, params, wsum, k, precision, out=spare)
            spare, cur = cur, nxt
        return cur

    return multi
