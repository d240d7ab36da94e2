"""The CSR strip-gather tier of the unstructured operator — counterpart of
``nonlocalheatequation_tpu/ops/pallas_gather.py``.

The eps-ball operator on a point cloud is a fixed sparsity pattern
(ops/unstructured.py builds the edge list once), so a step is a gather and
a row sum over a table with the per-row constants baked in:

    W[i, j] = c_i * w_ij   for the neighbours, then   (-c_i * wsum_i, col i)

so that ``L(u)[i] = sum_k W[i, k] * u[col[i, k]]``.  :func:`pack_strips`
gives that table in the JAX package's strip form (rows padded with zero
weights to a 128-lane quantum); :func:`csr_table` gives the same baked
entries in CSR form (row pointers, no padding), which the ``gather_L``
kernel reads (ops/cuda_unstructured.py, csrc/gather_L.cu; it replaces the
Pallas ``build_gather_L``) at the lanes a row :func:`gather_width` picks and
in the visit order :func:`gather_order` picks.  ``precision="bf16"`` rounds
each gathered value of the state once to bfloat16; the weights and the sum
stay in the state dtype.

The step makers mirror the JAX package's: per-step, multi-step, and the
stacked ensemble form, whose lane b is bitwise the solo run (the kernel's
order of adds is fixed by the row).  The ensemble engine's mesh buckets
run them (serve/ensemble.py).
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.ops import cuda_unstructured
from nonlocalheatequation_torch.ops.nonlocal_op import source_at
from nonlocalheatequation_torch.ops.windowed import morton_perm
from nonlocalheatequation_torch.utils.devices import resolve_dtype

#: lane quantum of the strip width (the JAX package's f32 tile lane count)
LANE = 128


def csr_arrays(op):
    """The operator's neighbour table in CSR form: ``(offsets, cols, w)``
    with ``offsets`` (n+1,) int64 row starts, ``cols`` (nnz,) int32 and
    ``w`` (nnz,) f64 in build_edges order (rows ascending, columns ascending
    within a row)."""
    n, tgt = op.n, op.tgt
    deg = np.bincount(tgt, minlength=n) if len(tgt) else np.zeros(n, np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    return offsets, op.src.astype(np.int32), op.edge_w.astype(np.float64)


def pack_strips(op, dtype_name: str = "float32"):
    """The baked table as ``(col, w)`` strips of shape (n, kpad): per row
    its neighbour columns and ``c_i``-scaled weights, then the
    ``(-c_i * wsum_i, i)`` centre entry, zero-weight padded to a multiple of
    128 lanes; ``w`` in ``dtype_name``, rounded once from float64.  The JAX
    package's ``pack_strips`` rows 0..n-1 (it also pads the row count to its
    TPU strip height).  Cached on the op, keyed by dtype."""
    cache = op.__dict__.setdefault("_gather_strips", {})
    hit = cache.get(dtype_name)
    if hit is not None:
        return hit
    offsets, cols, w = csr_arrays(op)
    n = op.n
    kpad = max(LANE, -(-(op.kmax + 1) // LANE) * LANE)
    col = np.zeros((n, kpad), np.int32)
    wst = np.zeros((n, kpad), np.float64)
    if len(cols):
        tgt = op.tgt
        pos = np.arange(len(cols)) - offsets[tgt]
        col[tgt, pos] = cols
        wst[tgt, pos] = op.c[tgt] * w
    rows = np.arange(n)
    deg = np.diff(offsets)
    col[rows, deg] = rows
    wst[rows, deg] = -op.c * op.wsum
    out = cache[dtype_name] = (col, wst.astype(np.dtype(dtype_name)))
    return out


def csr_table(op):
    """The baked table in CSR form: ``(rowptr, col, w)`` with ``rowptr``
    (n+1,) int64, ``col`` int32 and ``w`` float64; row i holds its deg_i
    neighbour entries ``c_i * w_ij`` in build_edges order, then the centre
    entry ``(-c_i * wsum_i, i)`` — the strips' entries without their
    padding."""
    offsets, cols, w = csr_arrays(op)
    n = op.n
    rows = np.arange(n)
    rowptr = offsets + np.arange(n + 1)
    col = np.empty(len(cols) + n, np.int32)
    wc = np.empty(len(cols) + n, np.float64)
    if len(cols):
        at = np.arange(len(cols)) + op.tgt  # entry e of row t sits at e + t
        col[at] = cols
        wc[at] = op.c[op.tgt] * w
    centre = offsets[1:] + rows
    col[centre] = rows
    wc[centre] = -op.c * op.wsum
    return rowptr, col, wc


def gather_width(nnz: int, n: int) -> int:
    """The ``gather_L`` kernel's lanes a row for a table of ``nnz`` entries
    over ``n`` rows: the smallest width whose iteration (8 entries a lane)
    covers a row of the mean length, 4 up to 32 entries a row, 8 up to 64,
    16 up to 128, else 32; 32 for an empty table.  A lane issues its 8
    column and weight loads before its first gather of u, so a narrow group
    keeps a short row's loads in flight in one iteration, where the first
    form (32 lanes, one entry a lane) waited on one chain of loads a row;
    every width gives the same bits (csrc/gather_L.cu).  The rule is the
    fastest width, or level with it, at every point cloud that
    ``chip_smoke.py --ab DIR unstructured`` times on an H100 (80GB HBM3,
    700 W, ms a launch in a CUDA graph, in the visit order
    :func:`gather_order` picks): 4 at 28 entries a row (lattice-order 512^2
    0.0254 against 0.0298 at 8; shuffled 512^2 0.0386 against 0.0428), 8
    at 42-50 (64^3 at eps 2.2h 0.0384 against 0.0434 at 4 and 0.0498 at
    16, shuffled 0.0553 against 0.0581 at 4; shuffled 512^2 at eps 4h
    0.0549 against 0.0574 at 4 and 0.0641 at 16), 16 at the 68 of 64^3 at eps 2.5h (0.0582 against
    0.0602 at 8; shuffled 0.0790 at 8 and 16), 32 at the 223 of the graded
    cloud (0.0429 against 0.0441 at 16).  Tables of random columns with no
    points to order them by are not what a cloud gives and run best at 32
    from 64 entries a row (0.1379 ms against the rule's 0.1553 at 64 a row,
    0.2647 against 0.2849 at 128); no caller builds one."""
    if n <= 0:
        return 32
    mean = -(-nnz // n)
    for width in (4, 8, 16):
        if mean <= 8 * width:
            return width
    return 32


def gather_order(op):
    """The order in which the ``gather_L`` kernel visits the op's rows, as
    int32, or None for row order.  Where a row's columns lie near it (the
    mean ``|col - row|`` at most n/4, where a random numbering gives n/3: a
    lattice-ordered or meshed numbering) consecutive rows gather the same
    lines of u, and row order keeps that.  Where they lie far (a shuffled
    numbering), consecutive rows share nothing and every gathered value
    costs a sector from L2; visiting the rows in the Morton order of their
    points (ops/windowed.morton_perm, cells of the largest horizon) makes
    the rows a block visits neighbours, so their gathers share lines in L1.
    The table and the numbering stay as they are: the order changes no bit.
    On an H100 (``chip_smoke.py --ab DIR unstructured``) the shuffled 512^2
    cloud takes 0.039 ms in this order against 0.071 in row order, and the
    lattice-ordered one 0.025 in row order against 0.028 in this one."""
    n = op.n
    if n == 0 or len(op.tgt) == 0:
        return None
    if np.abs(op.src.astype(np.int64) - op.tgt).mean() <= n / 4:
        return None
    cell = max(float(np.max(op.eps)), np.finfo(np.float64).tiny)
    return morton_perm(op.points, cell).astype(np.int32)


class GatherTable:
    """One operator's baked CSR table as tensors in ``dtype`` on ``device``,
    the kernel's lanes a row for it (:func:`gather_width`) and the order in
    which it visits the rows (:func:`gather_order`)."""

    def __init__(self, op, dtype: torch.dtype, device):
        rowptr, col, w = csr_table(op)
        self.n = op.n
        self.rowptr = torch.as_tensor(rowptr).to(device)
        self.col = torch.as_tensor(col).to(device)
        self.w = torch.as_tensor(w).to(device=device, dtype=dtype)
        self.width = gather_width(len(col), op.n)
        order = gather_order(op)
        self.order = (None if order is None else
                      cuda_unstructured.VisitOrder(torch.as_tensor(order).to(device)))

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @classmethod
    def of(cls, op, dtype: torch.dtype, device) -> "GatherTable":
        """The op's table, built once per (dtype, device) and cached on the op
        (its edge set and constants are immutable, as ``pack_strips`` caches
        the strips): the lanes of a bucket that share an op, and a solo run
        of the same op, read one table."""
        cache = op.__dict__.setdefault("_gather_tables", {})
        key = (dtype, torch.device(device))
        if key not in cache:
            cache[key] = cls(op, dtype, device)
        return cache[key]


def build_gather_L(op, dtype=None, precision: str = "f32", device=None):
    """``L(u)`` as the ``gather_L`` kernel: ``(n,) -> (n,)`` in ``dtype``
    on ``device`` (default: the op's device, float64 on the CPU and float32
    on the card).  Held to ``op.apply(u, layout="edges")``: the same edges,
    one extra baked centre product per row."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown gather precision {precision!r}")
    device = op.device if device is None else torch.device(device)
    dtype = resolve_dtype(dtype, device)
    table = GatherTable.of(op, dtype, device)

    def L(u):
        return cuda_unstructured.gather_L(table.rowptr, table.col, table.w,
                                          u.to(dtype).contiguous(), precision, table.width,
                                          table.order)

    L.table = table
    return L


def make_gather_step_fn(op, dtype=None, test: bool = False, precision: str = "f32",
                        device=None):
    """``step(u, t) -> u + dt * (L(u) + b_t)`` over the ``gather_L`` kernel;
    ``test=True`` adds the manufactured source from the op's own profile."""
    device = op.device if device is None else torch.device(device)
    dtype = resolve_dtype(dtype, device)
    L = build_gather_L(op, dtype, precision, device)
    dt = op.dt
    if test:
        g, lg = op.source_parts()
        gd = torch.as_tensor(g).to(device=device, dtype=dtype)
        lgd = torch.as_tensor(lg).to(device=device, dtype=dtype)

    def step(u, t):
        du = L(u)
        if test:
            du = du + source_at(gd, lgd, t, dt)
        return u + dt * du

    return step


def make_gather_multi_step_fn(op, nt: int, dtype=None, test: bool = False,
                              precision: str = "f32", device=None):
    """``multi(u0, t0) -> u_nt``: ``nt`` steps of :func:`make_gather_step_fn`."""
    device = op.device if device is None else torch.device(device)
    dtype = resolve_dtype(dtype, device)
    step = make_gather_step_fn(op, dtype=dtype, test=test, precision=precision,
                               device=device)

    def multi(u0, t0):
        u = u0.to(device=device, dtype=dtype)
        for t in range(int(t0), int(t0) + nt):
            u = step(u, t)
        return u

    return multi


def make_batched_gather_multi_step_fn(ops, nt: int, dtype=None, test: bool = False,
                                      precision: str = "f32", device=None):
    """``multi(U0, t0) -> (B, n)``: one callable for a whole ensemble chunk,
    each case's solo loop in turn (the engine's stacked composition; cases
    in one mesh bucket share the edge table but may differ in physics, so
    each lane bakes its own table).  Lane b is bitwise
    ``make_gather_multi_step_fn(ops[b], nt)``."""
    device = ops[0].device if device is None else torch.device(device)
    dtype = resolve_dtype(dtype, device)
    solos = [make_gather_multi_step_fn(op, nt, dtype=dtype, test=test, precision=precision,
                                       device=device) for op in ops]

    def multi(U0, t0):
        return torch.stack([solo(U0[b], t0) for b, solo in enumerate(solos)])

    return multi
