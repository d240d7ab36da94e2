"""Windowed block-dense and offset (DIA) layouts of the unstructured
operator — counterpart of ``nonlocalheatequation_tpu/ops/windowed.py``.

The operator is L(u)_i = c_i * (sum_j w_ij u_j - wsum_i u_i) over radius
neighbourhoods of a point cloud (ops/unstructured.py).  Two layouts replace
the per-edge gather with streams the device reads in order:

* **windowed** — nodes reordered along a Morton (Z-order) curve over
  horizon-sized cells, so each run of ``bm`` = 128 consecutive rows draws
  its neighbours from R short windows of the reordered state; per row block
  the weights sit in a ``(bm, R*we)`` strip P whose column groups align to
  the block's 128-aligned window starts ``s128[b, r]``.  The card keeps only
  P's non-zeros, packed by row (:meth:`WindowedPlan.packed`), and the step
  is one launch of the ``windowed_matvec`` kernel over them
  (ops/cuda_unstructured.py, csrc/windowed_matvec.cu; it replaces the
  Pallas ``_build_windowed_matvec``, which streams the dense P).  Edges
  outside their block's windows go to a residual edge list summed with
  ``index_add_`` outside the kernel (the JAX package's ``segment_sum``), so
  any ordering stays exact.
* **offsets** — when the index offsets ``src - tgt`` cluster on a small set
  O (a jittered grid in its natural order), the operator is a sum of |O|
  diagonals: ``acc = sum_o W_o * shift(u, o)``, static shifted slices of a
  padded state in plain PyTorch (XLA lowered this without Pallas on the
  JAX side), with the same residual list for the uncovered edges.

The host-side plan search (Morton order, per-block window starts, the
width ladder) is the JAX package's NumPy code, so ``perm``, ``s128``,
``we``, R and P come out equal to its plan.  The port never allocates the
dense P on the device: the exec holds the packed entries in the target
dtype (rounded from float64 once).  The reduction order differs from
``apply_np`` (per-row accumulation; on the card the residual ``index_add_``
adds with atomics in an order that changes from run to run), so both
layouts are held to the oracle by tolerance, not bitwise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nonlocalheatequation_torch.ops import cuda_unstructured

LANE = 128

# W escalation ladder (all multiples of LANE); stops at the first rung whose
# out-of-window residual is small enough
_W_LADDER = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """sum of ``vals`` per target index (the JAX package's ``segment_sum``)."""
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(0, idx, vals)


def morton_perm(points: np.ndarray, cell: float) -> np.ndarray:
    """Stable Z-order permutation of points binned into ``cell``-sized cells.

    Generic in dimension: interleaves the cell-coordinate bits across dims
    (21 bits per dim).  Within a cell the original order is kept (stable
    sort).
    """
    pts = np.asarray(points, np.float64)
    if pts.shape[0] == 0:  # pts.min() on an empty axis raises
        return np.zeros(0, np.int64)
    cells = np.floor((pts - pts.min(axis=0)) / float(cell)).astype(np.uint64)
    n, d = cells.shape
    bits = min(21, 63 // max(d, 1))
    key = np.zeros(n, np.uint64)
    for b in range(bits):
        for j in range(d):
            key |= ((cells[:, j] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d + j)
    return np.argsort(key, kind="stable")


class _WindowedExec:
    """Per-(dtype, device) tensors of one plan and its step."""

    def __init__(self, plan: "WindowedPlan", dtype: torch.dtype, device: torch.device):
        self.n, self.bm, self.we = plan.n, plan.bm, plan.we
        as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a)).to(  # noqa: E731
            device=device, dtype=dt).contiguous()
        self.perm = as_t(plan.perm, torch.int64)
        self.rank = as_t(plan.rank, torch.int64)
        rowptr, cols, vals = plan.packed()
        self.rowptr = as_t(rowptr, torch.int32)
        self.cols = as_t(cols.view(np.int16), torch.int16)
        self.vals = as_t(vals)
        self.s128 = as_t(plan.s128, torch.int32)
        self.c_p = as_t(plan.c_p)
        self.wsum_p = as_t(plan.wsum_p)
        self.ov_tgt = as_t(plan.ov_tgt, torch.int64)
        self.ov_src = as_t(plan.ov_src, torch.int64)
        self.ov_w = as_t(plan.ov_w)
        self.has_overflow = plan.ov_tgt.size > 0

    def neighbor_sum_perm(self, u_perm: torch.Tensor) -> torch.Tensor:
        """sum_j w_ij u_j in Morton order (targets AND sources permuted)."""
        acc = cuda_unstructured.windowed_matvec(self.rowptr, self.cols, self.vals, self.s128,
                                                u_perm, self.we, self.bm)
        if self.has_overflow:
            acc = acc + _segment_sum(self.ov_w * u_perm[self.ov_src], self.ov_tgt, self.n)
        return acc

    def L_perm(self, u_perm: torch.Tensor) -> torch.Tensor:
        """The full operator in Morton order."""
        return self.c_p * (self.neighbor_sum_perm(u_perm) - self.wsum_p * u_perm)

    def L(self, u: torch.Tensor) -> torch.Tensor:
        """Original-order contract: permute in, invert out."""
        return self.L_perm(u[self.perm])[self.rank]


class WindowedPlan:
    """Host-side product of :func:`build_plan`; hands out per-dtype execs.

    ``W`` is the TOTAL strip width (R windows of ``we`` columns each);
    ``s128[b, r]`` is window r's start for block b in 128-row units.  The
    strips are kept as their in-window entries (``p_rows``, ``p_cols``,
    ``p_vals``), packed by row for the kernel by :meth:`packed`; :meth:`strips`
    lays them out densely (the JAX package's P, for the tests)."""

    def __init__(self, *, n, n_pad, bm, we, R, nb, perm, rank, s128, p_rows, p_cols,
                 p_vals, ov_tgt, ov_src, ov_w, c_p, wsum_p, coverage):
        self.n, self.n_pad, self.bm, self.nb = n, n_pad, bm, nb
        self.we, self.R, self.W = we, R, R * we
        self.perm, self.rank, self.s128 = perm, rank, s128
        self.p_rows, self.p_cols, self.p_vals = p_rows, p_cols, p_vals
        self.ov_tgt, self.ov_src, self.ov_w = ov_tgt, ov_src, ov_w
        self.c_p, self.wsum_p = c_p, wsum_p
        self.coverage = coverage  # fraction of edges inside windows
        self._execs: dict = {}
        self._packed = None

    @property
    def p_bytes_f32(self) -> int:
        return self.n_pad * self.W * 4

    def packed(self) -> tuple:
        """The in-window entries packed by row, as the kernel reads them:
        ``(rowptr, cols, vals)`` NumPy arrays, ``rowptr`` (n_pad+1,) int32,
        per entry its column in the block's R*we window (uint16) and its
        float64 weight, each row's entries by ascending column.  Computed
        once per plan."""
        if self._packed is None:
            if self.W > 1 << 16:
                raise ValueError(f"windowed plan: R*we = {self.W} columns exceed a uint16 "
                                 "column")
            order = np.lexsort((self.p_cols, self.p_rows))
            rowptr = np.zeros(self.n_pad + 1, np.int64)
            np.cumsum(np.bincount(self.p_rows, minlength=self.n_pad), out=rowptr[1:])
            if rowptr[-1] >= 1 << 31:
                raise ValueError(f"windowed plan: {rowptr[-1]} entries exceed an int32 row "
                                 "pointer")
            self._packed = (rowptr.astype(np.int32), self.p_cols[order].astype(np.uint16),
                            np.asarray(self.p_vals, np.float64)[order])
        return self._packed

    def strips(self, dtype: torch.dtype, device) -> torch.Tensor:
        """The dense ``(n_pad, R*we)`` strips P in ``dtype`` on ``device``:
        zeros, then each in-window weight (rounded from float64 once, as the
        JAX package's ``jnp.asarray(plan.P, dtype)``) at its column."""
        P = torch.zeros((self.n_pad, self.W), dtype=dtype, device=device)
        rows = torch.as_tensor(self.p_rows).to(device)
        cols = torch.as_tensor(self.p_cols).to(device)
        P[rows, cols] = torch.as_tensor(self.p_vals).to(device=device, dtype=dtype)
        return P

    def for_dtype(self, dtype: torch.dtype, device) -> _WindowedExec:
        device = torch.device(device)
        key = (dtype, device)
        if key not in self._execs:
            self._execs[key] = _WindowedExec(self, dtype, device)
        return self._execs[key]


def _plan_search(points, eps, tgt, src, edge_w, *, bm, wmax, max_overflow_frac, order,
                 windows):
    """The permutation + per-block column sets + W-ladder search shared by
    :func:`build_plan` and :func:`plan_stats` (the JAX package's code).  The
    dense strips are NOT materialized here, so a worthwhileness gate can
    reject a plan without paying its memory."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    tgt = np.asarray(tgt, np.int64)
    src = np.asarray(src, np.int64)
    edge_w = np.asarray(edge_w, np.float64)
    if order == "morton":
        cell = float(np.max(np.broadcast_to(np.asarray(eps, np.float64), (n,)))) if n else 1.0
        perm = morton_perm(points, max(cell, np.finfo(np.float64).tiny))
    elif order == "keep":
        perm = np.arange(n)
    else:
        raise ValueError(f"unknown order {order!r}")
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)

    n_pad = max(_round_up(n, bm), bm)
    nb = n_pad // bm

    tgt_p = rank[tgt]
    src_p = rank[src]
    order_e = np.argsort(tgt_p, kind="stable")
    tgt_s, src_s, w_s = tgt_p[order_e], src_p[order_e], edge_w[order_e]
    blk = tgt_s // bm
    blk_bounds = np.searchsorted(blk, np.arange(nb + 1))
    cols_by_blk = [np.sort(src_s[blk_bounds[b]:blk_bounds[b + 1]]) for b in range(nb)]

    total = len(tgt_s)
    wmax = min(_round_up(max(wmax, LANE), LANE), max(n_pad, LANE))
    # R windows of we columns each, total width R*we <= wmax; quadrant jumps
    # in the Morton curve split a block's sources into a few clusters
    R = max(1, min(int(windows), wmax // LANE))
    ladder = [w for w in _W_LADDER if R * w <= wmax]
    top = wmax // R // LANE * LANE
    if not ladder or top > ladder[-1]:
        ladder.append(top)

    def solve_starts(we):
        """Greedy per block: best window, then best window of the rest."""
        s128 = np.zeros((nb, R), np.int32)
        covered = 0
        for b, cols in enumerate(cols_by_blk):
            rest = cols
            for r in range(R):
                if rest.size == 0:
                    break
                cand = np.unique(rest // LANE) * LANE
                hi = np.searchsorted(rest, cand + we, side="left")
                lo = np.searchsorted(rest, cand, side="left")
                best = int(np.argmax(hi - lo))
                s = int(cand[best])
                s128[b, r] = s // LANE
                covered += int(hi[best] - lo[best])
                rest = rest[(rest < s) | (rest >= s + we)]
        return s128, covered

    for cand_w in ladder:
        s128, covered = solve_starts(cand_w)
        we = cand_w
        if total == 0 or (total - covered) <= max_overflow_frac * total:
            break

    return dict(n=n, n_pad=n_pad, nb=nb, R=R, we=we, perm=perm, rank=rank, tgt_s=tgt_s,
                src_s=src_s, w_s=w_s, blk=blk, s128=s128, covered=covered, total=total)


def plan_stats(points, eps, tgt, src, *, bm: int = LANE, wmax: int = 4096,
               max_overflow_frac: float = 0.02, order: str = "morton", windows: int = 2):
    """``(coverage, p_bytes_f32)`` of the plan :func:`build_plan` would
    produce under the same parameters, without materializing the strips."""
    sr = _plan_search(points, eps, tgt, src, np.zeros(np.asarray(tgt).shape[0], np.float64),
                      bm=bm, wmax=wmax, max_overflow_frac=max_overflow_frac, order=order,
                      windows=windows)
    coverage = 1.0 if sr["total"] == 0 else sr["covered"] / sr["total"]
    return coverage, sr["n_pad"] * sr["R"] * sr["we"] * 4


def _combine_duplicates(rows, cols, vals, width):
    """(rows, cols, vals) with repeated (row, col) pairs summed in float64 in
    edge order (``np.add.at``'s order, so a caller's duplicate edges add as
    the JAX package's dense fill adds them)."""
    keys = rows * np.int64(width) + cols
    uniq, inv = np.unique(keys, return_inverse=True)
    if len(uniq) == len(keys):
        return rows, cols, vals
    summed = np.bincount(inv, weights=vals, minlength=len(uniq))
    return uniq // width, uniq % width, summed


def build_plan(points, eps, tgt, src, edge_w, c, wsum, *, bm: int = LANE, wmax: int = 4096,
               max_overflow_frac: float = 0.02, order: str = "morton", windows: int = 2,
               search=None) -> WindowedPlan:
    """Build the windowed layout for an edge set (the JAX package's
    ``build_plan``; ``search`` takes a precomputed :func:`_plan_search`
    result run with the same inputs and the real ``edge_w``)."""
    sr = search if search is not None else _plan_search(
        points, eps, tgt, src, edge_w, bm=bm, wmax=wmax,
        max_overflow_frac=max_overflow_frac, order=order, windows=windows)
    n, n_pad, nb, R, we = sr["n"], sr["n_pad"], sr["nb"], sr["R"], sr["we"]
    perm, rank = sr["perm"], sr["rank"]
    tgt_s, src_s, w_s = sr["tgt_s"], sr["src_s"], sr["w_s"]
    blk, s128 = sr["blk"], sr["s128"]
    covered, total = sr["covered"], sr["total"]

    # every edge lands in the FIRST window that contains it (windows of one
    # block may overlap; the assigned mask keeps each edge in one column)
    rows, cols, vals = [], [], []
    assigned = np.zeros(total, bool)
    for r in range(R):
        off = src_s - s128[blk, r].astype(np.int64) * LANE
        in_r = (off >= 0) & (off < we) & ~assigned
        rows.append(tgt_s[in_r])
        cols.append(r * we + off[in_r])
        vals.append(w_s[in_r])
        assigned |= in_r
    ov = ~assigned
    p_rows, p_cols, p_vals = _combine_duplicates(
        np.concatenate(rows).astype(np.int64), np.concatenate(cols).astype(np.int64),
        np.concatenate(vals), R * we)

    return WindowedPlan(
        n=n, n_pad=n_pad, bm=bm, we=we, R=R, nb=nb, perm=perm, rank=rank, s128=s128,
        p_rows=p_rows, p_cols=p_cols, p_vals=p_vals,
        ov_tgt=tgt_s[ov].astype(np.int32), ov_src=src_s[ov].astype(np.int32), ov_w=w_s[ov],
        c_p=np.asarray(c, np.float64)[perm], wsum_p=np.asarray(wsum, np.float64)[perm],
        coverage=1.0 if total == 0 else covered / total,
    )


# --------------------------------------------------------------------------
# Offset (DIA) layout
# --------------------------------------------------------------------------


class _OffsetExec:
    """Per-(dtype, device) tensors of one :class:`OffsetPlan`."""

    def __init__(self, plan: "OffsetPlan", dtype: torch.dtype, device: torch.device):
        as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a)).to(  # noqa: E731
            device=device, dtype=dt).contiguous()
        self.n, self.offs = plan.n, plan.offs
        self.pad_lo, self.pad_hi = plan.pad_lo, plan.pad_hi
        self.W = as_t(plan.W)
        self.c = as_t(plan.c)
        self.wsum = as_t(plan.wsum)
        self.ov_tgt = as_t(plan.ov_tgt, torch.int64)
        self.ov_src = as_t(plan.ov_src, torch.int64)
        self.ov_w = as_t(plan.ov_w)
        self.has_overflow = plan.ov_tgt.size > 0

    def neighbor_sum(self, u: torch.Tensor) -> torch.Tensor:
        """sum_j w_ij u_j as a static-slice diagonal sum (original order)."""
        up = F.pad(u, (self.pad_lo, self.pad_hi))
        acc = torch.zeros_like(u)
        for j, o in enumerate(self.offs):
            start = self.pad_lo + o
            acc = acc + self.W[j] * up[start:start + self.n]
        if self.has_overflow:
            acc = acc + _segment_sum(self.ov_w * u[self.ov_src], self.ov_tgt, self.n)
        return acc

    def L(self, u: torch.Tensor) -> torch.Tensor:
        return self.c * (self.neighbor_sum(u) - self.wsum * u)


class OffsetPlan:
    """Host-side product of :func:`build_offset_plan`."""

    def __init__(self, *, n, offs, W, pad_lo, pad_hi, ov_tgt, ov_src, ov_w, c, wsum,
                 coverage):
        self.n, self.offs, self.W = n, offs, W
        self.pad_lo, self.pad_hi = pad_lo, pad_hi
        self.ov_tgt, self.ov_src, self.ov_w = ov_tgt, ov_src, ov_w
        self.c, self.wsum = c, wsum
        self.coverage = coverage
        self._execs: dict = {}

    @property
    def w_bytes_f32(self) -> int:
        return self.W.size * 4

    def for_dtype(self, dtype: torch.dtype, device) -> _OffsetExec:
        device = torch.device(device)
        key = (dtype, device)
        if key not in self._execs:
            self._execs[key] = _OffsetExec(self, dtype, device)
        return self._execs[key]


def offset_stats(tgt, src, n, *, max_offsets: int = 256, coverage_target: float = 1.0):
    """(coverage, kept_offsets, w_bytes_f32) of the offset layout, without
    materializing the dense diagonals."""
    tgt = np.asarray(tgt, np.int64)
    src = np.asarray(src, np.int64)
    E = len(tgt)
    if E == 0:
        return 1.0, 0, 0
    vals, counts = np.unique(src - tgt, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    csum = np.cumsum(counts[order]) / E
    keep_n = int(np.searchsorted(csum, coverage_target - 1e-15) + 1)
    keep_n = min(keep_n, max_offsets, len(vals))
    coverage = float(csum[keep_n - 1]) if keep_n else 0.0
    return coverage, keep_n, keep_n * n * 4


def build_offset_plan(tgt, src, edge_w, c, wsum, n, *, max_offsets: int = 256,
                      coverage_target: float = 1.0) -> OffsetPlan:
    """Detect the dominant index offsets and lay their weights out as dense
    diagonals; offsets are kept most-common-first until ``coverage_target``
    of the edges is reached or ``max_offsets`` is hit, the rest go to the
    residual edge list.  No reordering: the caller's node order is the
    structure this layout exploits."""
    tgt = np.asarray(tgt, np.int64)
    src = np.asarray(src, np.int64)
    edge_w = np.asarray(edge_w, np.float64)
    E = len(tgt)
    off = src - tgt
    vals, counts = (np.unique(off, return_counts=True) if E
                    else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
    order = np.argsort(-counts, kind="stable")
    keep_n = len(vals)
    if E:
        csum = np.cumsum(counts[order]) / E
        keep_n = int(np.searchsorted(csum, coverage_target - 1e-15) + 1)
    keep_n = min(keep_n, max_offsets, len(vals))
    kept = np.sort(vals[order[:keep_n]])
    slot = np.searchsorted(kept, off)
    inw = ((slot < len(kept)) & (kept[np.minimum(slot, max(len(kept) - 1, 0))] == off)
           if len(kept) else np.zeros(E, bool))
    W = np.zeros((len(kept), n), np.float64)
    # (tgt, off) pairs are unique exactly when (tgt, src) pairs are; a caller's
    # duplicate edges add up
    pair_keys = tgt * np.int64(max(n, 1)) + src
    if len(pair_keys) == len(np.unique(pair_keys)):
        W[slot[inw], tgt[inw]] = edge_w[inw]
    else:
        np.add.at(W, (slot[inw], tgt[inw]), edge_w[inw])
    ov = ~inw
    offs = tuple(int(o) for o in kept)
    return OffsetPlan(
        n=n, offs=offs, W=W,
        pad_lo=max(0, -min(offs)) if offs else 0,
        pad_hi=max(0, max(offs)) if offs else 0,
        ov_tgt=tgt[ov].astype(np.int32), ov_src=src[ov].astype(np.int32), ov_w=edge_w[ov],
        c=np.asarray(c, np.float64), wsum=np.asarray(wsum, np.float64),
        coverage=1.0 if E == 0 else float(inw.sum()) / E,
    )
