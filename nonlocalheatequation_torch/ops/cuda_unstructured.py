"""The unstructured kernels of the port: wrappers, plain versions and launch
counts.

Two hand-written CUDA kernels (csrc/) replace the two Pallas kernels of the
unstructured path:

* :func:`windowed_matvec` replaces ``_build_windowed_matvec``
  (nonlocalheatequation_tpu/ops/windowed.py:151): the Morton-order windowed
  matvec of ``layout="windowed"`` (ops/windowed.py), over the plan's
  in-window entries packed by row instead of the TPU kernel's dense strips
  (:func:`dense_matvec_plain` keeps that form for the tests);
* :func:`gather_L` replaces ``build_gather_L``
  (nonlocalheatequation_tpu/ops/pallas_gather.py:144): the CSR strip gather
  over the baked ``c_i*w_ij`` and centre entries of ops/gather.py, with
  its bf16 operand tier.

As in ops/cuda_kernel.py (which holds the launch counts and the C entry
points): each wrapper checks its arguments, allocates its output with
``torch.empty``, launches on the current stream, raises on a non-zero
launch status and counts the launch in ``LAUNCHES``.  A CPU tensor goes to
the plain version beside it (a gather from the windows and a row segment
sum; a gather and a row sum); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nonlocalheatequation_torch.ops.constants import validate_precision
from nonlocalheatequation_torch.ops.cuda_kernel import (
    _DTYPE_CODE,
    LAUNCHES,
    _check_device,
    _entry,
    bf16_round,
)

LANE = 128


def _check(name: str, x: torch.Tensor, dtype, like: torch.Tensor, ndim: int):
    if x.dtype != dtype or x.device != like.device or x.dim() != ndim:
        raise ValueError(f"{name}: needs a {ndim}-D {dtype} tensor on {like.device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _raise_status(rc: int, what: str, detail: str):
    if rc == -1:
        raise ValueError(f"{what}: {detail} is beyond what the kernel takes (its limits, "
                         f"csrc/{what}.cu)")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError {rc}")


# -- windowed matvec (B13) -------------------------------------------------------

def _check_windowed(rowptr, cols, vals, s128, u, we, bm):
    if u.dtype not in _DTYPE_CODE or u.dim() != 1:
        raise TypeError(f"windowed_matvec: u must be a 1-D float32/float64 tensor, got "
                        f"{tuple(u.shape)} {u.dtype}")
    if bm != LANE or we < LANE or we % LANE:
        raise ValueError(f"windowed_matvec: bm must be {LANE} and we a multiple of {LANE}, "
                         f"got bm={bm}, we={we}")
    _check("windowed_matvec s128", s128, torch.int32, u, 2)
    _check("windowed_matvec rowptr", rowptr, torch.int32, u, 1)
    _check("windowed_matvec cols", cols, torch.int16, u, 1)
    _check("windowed_matvec vals", vals, u.dtype, u, 1)
    nb, R = s128.shape
    if rowptr.shape[0] != nb * bm + 1 or nb * bm < u.shape[0] or cols.shape != vals.shape:
        raise ValueError(f"windowed_matvec: rowptr {tuple(rowptr.shape)}, cols "
                         f"{tuple(cols.shape)} and vals {tuple(vals.shape)} do not match s128 "
                         f"{tuple(s128.shape)}, bm={bm} and n={u.shape[0]}")


def windows_of(s128: torch.Tensor, u: torch.Tensor, we: int, bm: int = LANE) -> torch.Tensor:
    """Each row block's R windows of ``u`` side by side, ``(nb, R*we)``:
    window r of block b is ``u[s128[b, r]*128 :][:we]``, 0 past n."""
    nb, R = s128.shape
    upad = F.pad(u, (0, nb * bm + we - u.shape[0]))
    return upad.unfold(0, we, LANE)[s128.long()].reshape(nb, R * we)


def dense_matvec_plain(P: torch.Tensor, s128: torch.Tensor, u: torch.Tensor, we: int,
                       bm: int = LANE) -> torch.Tensor:
    """The TPU kernel's form: the dense strips ``P`` (nb*bm, R*we) times
    each row block's windows of ``u``, one batched product over the
    blocks."""
    nb, _ = s128.shape
    out = torch.bmm(P.view(nb, bm, -1), windows_of(s128, u, we, bm).unsqueeze(2))
    return out.reshape(nb * bm)[:u.shape[0]]


def windowed_matvec_plain(rowptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                          s128: torch.Tensor, u: torch.Tensor, we: int,
                          bm: int = LANE) -> torch.Tensor:
    """The packed matvec as a gather of each entry's window value and a
    segment sum over the rows."""
    n = u.shape[0]
    counts = rowptr.diff().long()
    rows = torch.repeat_interleave(torch.arange(counts.shape[0], device=u.device), counts)
    g = windows_of(s128, u, we, bm)[rows // bm, cols.long() & 0xFFFF]
    return torch.zeros(counts.shape[0], dtype=u.dtype, device=u.device).index_add_(
        0, rows, vals * g)[:n]


def windowed_matvec(rowptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                    s128: torch.Tensor, u: torch.Tensor, we: int,
                    bm: int = LANE) -> torch.Tensor:
    """``out[row] = sum_{k in row} vals[k] * win_b[cols[k]]`` for the rows
    below n = len(u), over the packed in-window entries of a windowed plan
    (``WindowedPlan.packed``): ``rowptr`` (nb*bm+1,) int32, ``cols`` int16
    holding each entry's uint16 column in its row block's concatenated R*we
    window, ``vals`` in u's dtype; ``win_b`` is block b's windows
    (:func:`windows_of`: starts ``s128`` (nb, R) int32 in 128-value units,
    0 past n); u in Morton order."""
    _check_windowed(rowptr, cols, vals, s128, u, we, bm)
    if u.device.type == "cpu":
        return windowed_matvec_plain(rowptr, cols, vals, s128, u, we, bm)
    _check_device(u)
    if not u.is_contiguous():
        raise ValueError("windowed_matvec u: the kernel takes contiguous tensors")
    n = u.shape[0]
    nb, R = s128.shape
    out = torch.empty(n, dtype=u.dtype, device=u.device)
    if n == 0:
        return out
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_windowed_matvec")(
            _DTYPE_CODE[u.dtype], rowptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            s128.data_ptr(), u.data_ptr(), out.data_ptr(), n, nb, R, we,
            torch.cuda.current_stream().cuda_stream)
    _raise_status(rc, "windowed_matvec", f"R={R} windows of we={we} {u.dtype} values")
    LAUNCHES["windowed_matvec"] += 1
    return out


# -- CSR strip gather (B12) ------------------------------------------------------

def _check_gather(rowptr, col, w, u):
    if u.dtype not in _DTYPE_CODE or u.dim() != 1:
        raise TypeError(f"gather_L: u must be a 1-D float32/float64 tensor, got "
                        f"{tuple(u.shape)} {u.dtype}")
    _check("gather_L rowptr", rowptr, torch.int64, u, 1)
    _check("gather_L col", col, torch.int32, u, 1)
    _check("gather_L w", w, u.dtype, u, 1)
    if rowptr.shape[0] != u.shape[0] + 1 or col.shape != w.shape:
        raise ValueError(f"gather_L: rowptr {tuple(rowptr.shape)}, col {tuple(col.shape)} "
                         f"and w {tuple(w.shape)} do not fit a state of {u.shape[0]} nodes")


def gather_L_plain(rowptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The gather as a gather of u and a row sum of the weighted values."""
    n = u.shape[0]
    g = u[col.long()]
    if precision == "bf16":
        g = bf16_round(g)
    rows = torch.repeat_interleave(torch.arange(n, device=u.device), rowptr.diff())
    return torch.zeros(n, dtype=u.dtype, device=u.device).index_add_(0, rows, w * g)


def gather_L(rowptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
             precision: str = "f32") -> torch.Tensor:
    """``out[i] = sum_{k in row i} w[k] * u[col[k]]`` over a CSR table:
    ``rowptr`` (n+1,) int64, ``col`` int32 and ``w`` in u's dtype.
    ``precision="bf16"`` rounds each gathered value of u to bfloat16 (through
    float32) before the multiply; weights and sum stay in u's dtype."""
    validate_precision(precision)
    _check_gather(rowptr, col, w, u)
    if u.device.type == "cpu":
        return gather_L_plain(rowptr, col, w, u, precision)
    _check_device(u)
    if not u.is_contiguous():
        raise ValueError("gather_L u: the kernel takes contiguous tensors")
    n = u.shape[0]
    out = torch.empty(n, dtype=u.dtype, device=u.device)
    if n == 0:
        return out
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_gather_L")(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), rowptr.data_ptr(),
            col.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    _raise_status(rc, "gather_L", f"a {u.dtype} state")
    LAUNCHES["gather_L"] += 1
    return out
