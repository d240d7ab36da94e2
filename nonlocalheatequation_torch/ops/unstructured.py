"""Variable-horizon nonlocal operator on unstructured point clouds —
counterpart of ``nonlocalheatequation_tpu/ops/unstructured.py``.

    L(u)[i] = c_i * sum_{j in N(i)} J(|x_j - x_i| / eps_i) (u_j - u_i) * vol_j

with N(i) = {j : |x_j - x_i| <= eps_i} (the centre point included) and the
per-point constant from exact discrete moment matching,

    c_i = 2 * d * k / sum_j |x_j - x_i|^2 * J(.) * vol_j.

The neighbour structure is a static edge list built once on the host
(:func:`build_edges`: the OpenMP builder native/build/libedges.so when it
is built, else NumPy).  ``apply(u, layout)`` evaluates L on u's device in
one of five layouts, the same edges each way and a different reduction
order: ``offsets`` and ``windowed`` (ops/windowed.py; windowed runs the
``windowed_matvec`` kernel on the card), ``ell`` (padded-row gather and row
sum), ``edges`` (``index_add_``, the JAX package's ``segment_sum``) and
``auto`` (:meth:`UnstructuredNonlocalOp.choose_layout`).  The JAX package's
gates test for a TPU backend; here they test the operator's device, and a
CUDA device is treated as the TPU is.

Not ported yet, and refused by name: ``ShardedUnstructuredOp`` with its
ring halo, the solver's ``superstep > 1`` and checkpointing (the
distributed slice).  The JAX package's ``NLHEAT_WINDOWED``,
``NLHEAT_OFFSETS`` and ``NLHEAT_WINDOWED_BUDGET_MB`` knobs are not read:
nothing in the port sets them, and the budget is a constant.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nonlocalheatequation_torch.ops.nonlocal_op import source_at
from nonlocalheatequation_torch.utils.devices import resolve_device, resolve_dtype

#: candidate pairs per vectorized distance pass of the NumPy edge builder
_PAIRS_PER_PASS = 1 << 22

_native = []  # [lib or None], loaded at the first build


def _native_lib():
    if not _native:
        from nonlocalheatequation_torch.utils.native import load_native_lib

        lib = load_native_lib("libedges.so", ("nl_edges_count", "nl_edges_fill"))
        if lib is not None:
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.nl_edges_count.restype = ctypes.c_int64
            lib.nl_edges_count.argtypes = [ctypes.c_int32, ctypes.c_int64, f64p, f64p, i64p]
            lib.nl_edges_fill.restype = None
            lib.nl_edges_fill.argtypes = [ctypes.c_int32, ctypes.c_int64, f64p, f64p, i64p,
                                          i32p, i32p]
        _native.append(lib)
    return _native[0]


def _build_edges_native(points: np.ndarray, eps: np.ndarray):
    """The OpenMP cell-binned search; None when unavailable or unsuitable
    (same membership rule and output order as the NumPy builder; d <= 3)."""
    n, d = points.shape
    lib = _native_lib()
    if lib is None or d > 3:
        return None
    pts = np.ascontiguousarray(points, np.float64)
    eps = np.ascontiguousarray(eps, np.float64)
    deg = np.zeros(n, np.int64)
    total = lib.nl_edges_count(d, n, pts, eps, deg)
    if total < 0:  # invalid input or key-packing overflow: fall back
        return None
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    tgt = np.empty(total, np.int32)
    src = np.empty(total, np.int32)
    lib.nl_edges_fill(d, n, pts, eps, starts, tgt, src)
    return tgt, src


def build_edges(points: np.ndarray, eps: np.ndarray):
    """Radius-neighbour edge list via cell binning on the host.

    points: (N, d) float64; eps: (N,) per-point horizon radii.  Returns
    (targets, sources) int32 arrays sorted by (target, source), centre
    included.  The JAX package's rule and order: one global cell size
    ``eps.max()``, candidates from the +/-1 cell neighbourhood, membership
    ``|x_j - x_i|^2 <= eps_i^2 * (1 + 1e-12)`` with the squared distance
    summed over the axes in order.  The NumPy form here runs the candidate
    pairs of many cells per vectorized pass instead of one cell per Python
    iteration; the set of pairs, and so the sorted output, is the same.
    """
    points = np.asarray(points, np.float64)
    eps = np.broadcast_to(np.asarray(eps, np.float64), (points.shape[0],))
    n, d = points.shape
    cell = float(eps.max())
    if cell <= 0:
        raise ValueError("horizon radii must be positive")
    native = _build_edges_native(points, eps)
    if native is not None:
        return native
    keys = np.floor((points - points.min(axis=0)) / cell).astype(np.int64)
    # number the occupied cells only: their key rows, sorted, searched as
    # one record each (any extent, as the JAX package's dict of cells)
    rows, cell_of = np.unique(keys, axis=0, return_inverse=True)
    as_records = [("", np.int64)] * d
    cells = np.ascontiguousarray(rows).view(as_records).ravel()
    order = np.argsort(cell_of.ravel(), kind="stable")
    count = np.bincount(cell_of.ravel(), minlength=len(cells))
    first = np.cumsum(count) - count
    # the points in cell order, one contiguous array per axis
    axes = [np.ascontiguousarray(points[order, j]) for j in range(d)]
    eps2 = eps[order] ** 2
    offsets = np.array(np.meshgrid(*([(-1, 0, 1)] * d), indexing="ij")).reshape(d, -1).T
    # every (cell, neighbour cell) block of candidate pairs
    blocks = []
    for off in offsets:
        nb = np.ascontiguousarray(rows + off).view(as_records).ravel()
        pos = np.minimum(np.searchsorted(cells, nb), len(cells) - 1)
        hit = np.nonzero(cells[pos] == nb)[0]
        blocks.append(np.stack([hit, pos[hit]], axis=1))
    blocks = np.concatenate(blocks)
    a_first, b_first = first[blocks[:, 0]], first[blocks[:, 1]]
    b_cnt = count[blocks[:, 1]]
    sizes = count[blocks[:, 0]] * b_cnt
    ends = np.cumsum(sizes)
    targets, sources = [], []
    lo = 0
    while lo < len(blocks):
        hi = int(np.searchsorted(ends, ends[lo] - sizes[lo] + _PAIRS_PER_PASS, side="right"))
        hi = max(hi, lo + 1)
        sz = sizes[lo:hi]
        blk = np.repeat(np.arange(lo, hi), sz)
        local = np.arange(int(sz.sum())) - np.repeat(np.cumsum(sz) - sz, sz)
        i = local // b_cnt[blk]
        mem = a_first[blk] + i
        cand = b_first[blk] + (local - i * b_cnt[blk])
        diff = axes[0][mem] - axes[0][cand]
        dist2 = diff * diff
        for x in axes[1:]:
            diff = x[mem] - x[cand]
            dist2 = dist2 + diff * diff
        keep = dist2 <= eps2[mem] * (1 + 1e-12)
        targets.append(mem[keep])
        sources.append(cand[keep])
        lo = hi
    tgt = order[np.concatenate(targets)]
    src = order[np.concatenate(sources)]
    # (tgt, src) pairs are unique: one key sorts them as lexsort((src, tgt))
    by = np.argsort(tgt * np.int64(n) + src)
    return tgt[by].astype(np.int32), src[by].astype(np.int32)


def _sum_at(index: np.ndarray, values: np.ndarray, n: int) -> np.ndarray:
    """``np.add.at(zeros(n), index, values)``: the same sums in the same
    order, by ``np.bincount``."""
    return np.bincount(index, weights=values, minlength=n)


class UnstructuredNonlocalOp:
    """Nonlocal horizon operator for arbitrary node sets (any dimension).

    ``device`` (the CUDA card unless ``"cpu"``) is where the layouts'
    tensors go by default and what the auto policy judges.  ``edges`` takes
    a precomputed ``build_edges(points, eps)`` result (serve/meshes.py
    passes its hash-verified table)."""

    def __init__(self, points: np.ndarray, eps, k: float, dt: float, vol=None,
                 influence=None, c=None, device=None, edges=None):
        self.device = resolve_device(device)
        self.points = np.asarray(points, np.float64)
        n, d = self.points.shape
        self.n, self.d = n, d
        self.eps = np.broadcast_to(np.asarray(eps, np.float64), (n,)).copy()
        self.k = float(k)
        self.dt = float(dt)
        self.vol = (np.ones(n) if vol is None
                    else np.broadcast_to(np.asarray(vol, np.float64), (n,)).copy())
        tgt, src = build_edges(self.points, self.eps) if edges is None else edges
        self.tgt, self.src = np.asarray(tgt, np.int32), np.asarray(src, np.int32)
        tgt, src = self.tgt, self.src
        diff = self.points[src] - self.points[tgt]
        dist = np.sqrt(np.einsum("ij,ij->i", diff, diff))
        if influence is None:
            w = np.ones(len(tgt))
        else:
            # J(|x_j - x_i| / eps_i): normalized by the target's horizon
            w = np.vectorize(influence)(dist / self.eps[tgt])
        self.edge_w = w * self.vol[src]
        # exact discrete moment matching per point
        m2 = _sum_at(tgt, dist * dist * self.edge_w, n)
        if c is None:
            with np.errstate(divide="ignore"):
                self.c = np.where(m2 > 0, 2.0 * d * self.k / m2, 0.0)
        else:
            self.c = np.broadcast_to(np.asarray(c, np.float64), (n,)).copy()
        # row sums of weights (the u_i coefficient; the centre adds zero)
        self.wsum = _sum_at(tgt, self.edge_w, n)
        deg = np.bincount(tgt, minlength=n) if len(tgt) else np.zeros(n, np.int64)
        self.kmax = int(deg.max()) if len(tgt) else 0
        self._ell_arrays = None  # built lazily; see _ell()
        self._windowed_plan = None  # built lazily; see windowed_plan()
        self._windowed_stats = None  # cached (coverage, p_bytes) precheck
        self._windowed_search = None  # the gate's ladder search, reused
        self._offset_plan = None  # built lazily; see offset_plan()
        self._offset_stats = None  # cached (coverage, kept, w_bytes) precheck
        self._tensors: dict = {}  # (name, dtype, device) -> tensor

    def _on(self, name: str, array, like: torch.Tensor, dtype=None) -> torch.Tensor:
        """The host array ``array`` as a tensor on ``like``'s device, in
        ``dtype`` (default ``like``'s), converted once per (dtype, device)."""
        dtype = like.dtype if dtype is None else dtype
        key = (name, dtype, like.device)
        t = self._tensors.get(key)
        if t is None:
            t = self._tensors[key] = torch.as_tensor(np.asarray(array)).to(
                device=like.device, dtype=dtype).contiguous()
        return t

    # ELL (padded-row) layout: neighbour columns and weights as dense
    # (n, kmax) with zero-weight padding, built lazily; "auto" falls back to
    # the edge list when padding would more than double the stored entries
    _ELL_MAX_PAD_RATIO = 2.0

    def _ell(self):
        if self._ell_arrays is None:
            n, tgt, src = self.n, self.tgt, self.src
            deg = np.bincount(tgt, minlength=n)
            starts = np.zeros(n + 1, np.int64)
            np.cumsum(deg, out=starts[1:])
            col = np.zeros((n, self.kmax), np.int32)
            w = np.zeros((n, self.kmax), np.float64)
            pos = np.arange(len(tgt)) - starts[tgt]
            col[tgt, pos] = src
            w[tgt, pos] = self.edge_w
            self._ell_arrays = (col, w)
        return self._ell_arrays

    def _ell_worthwhile(self) -> bool:
        return (len(self.tgt) > 0
                and self.n * self.kmax <= self._ELL_MAX_PAD_RATIO * len(self.tgt))

    # Windowed block-dense layout (ops/windowed.py): worthwhile when the
    # cloud is large, the Morton windows capture the edges, and the strips
    # fit the budget (the JAX package's 2048 MB default, a constant here)
    _WINDOWED_MIN_N = 65536
    _WINDOWED_MIN_COVERAGE = 0.90
    _WINDOWED_BUDGET_BYTES = 2048 << 20

    def windowed_plan(self, **kwargs):
        """Build and return the windowed layout plan (cached per kwargs)."""
        key = tuple(sorted(kwargs.items()))
        if self._windowed_plan is None or self._windowed_plan[0] != key:
            from nonlocalheatequation_torch.ops.windowed import build_plan

            # default-kwargs builds reuse the gate's ladder search
            search = self._windowed_search if not kwargs else None
            self._windowed_plan = (key, build_plan(
                self.points, self.eps, self.tgt, self.src, self.edge_w, self.c, self.wsum,
                search=search, **kwargs))
        return self._windowed_plan[1]

    def _windowed_worthwhile(self) -> bool:
        if self.n < self._WINDOWED_MIN_N or len(self.tgt) == 0:
            return False
        if self.device.type != "cuda":
            # gathers are cheap on the CPU; the strips only pay off where
            # the gather path is the bottleneck
            return False
        if self._windowed_stats is None:
            from nonlocalheatequation_torch.ops.windowed import _plan_search

            sr = _plan_search(self.points, self.eps, self.tgt, self.src, self.edge_w,
                              bm=128, wmax=4096, max_overflow_frac=0.02, order="morton",
                              windows=2)
            self._windowed_search = sr
            cov = 1.0 if sr["total"] == 0 else sr["covered"] / sr["total"]
            self._windowed_stats = (cov, sr["n_pad"] * sr["R"] * sr["we"] * 4)
        coverage, p_bytes = self._windowed_stats
        return (coverage >= self._WINDOWED_MIN_COVERAGE
                and p_bytes <= self._WINDOWED_BUDGET_BYTES)

    # Offset (DIA) layout: the fastest path when src-tgt index offsets
    # cluster (quasi-uniform clouds in their natural order)
    _OFFSETS_MIN_N = 4096
    _OFFSETS_MIN_COVERAGE = 0.98

    def offset_plan(self, **kwargs):
        """Build and return the diagonal-offset layout plan (cached per kwargs)."""
        key = tuple(sorted(kwargs.items()))
        if self._offset_plan is None or self._offset_plan[0] != key:
            from nonlocalheatequation_torch.ops.windowed import build_offset_plan

            self._offset_plan = (key, build_offset_plan(
                self.tgt, self.src, self.edge_w, self.c, self.wsum, self.n, **kwargs))
        return self._offset_plan[1]

    def _offsets_worthwhile(self) -> bool:
        if self.n < self._OFFSETS_MIN_N or len(self.tgt) == 0:
            return False
        if self.device.type != "cuda":
            return False
        if self._offset_stats is None:  # a histogram of every edge: once per op
            from nonlocalheatequation_torch.ops.windowed import offset_stats

            self._offset_stats = offset_stats(self.tgt, self.src, self.n)
        coverage, _, w_bytes = self._offset_stats
        return (coverage >= self._OFFSETS_MIN_COVERAGE
                and w_bytes <= self._WINDOWED_BUDGET_BYTES)

    def choose_layout(self) -> str:
        """The auto policy, in one place: offsets (quasi-grid clouds) >
        windowed (Morton-sortable clouds, on the card) > ELL > edges."""
        if self._offsets_worthwhile():
            return "offsets"
        if self._windowed_worthwhile():
            return "windowed"
        return "ell" if self._ell_worthwhile() else "edges"

    # -- operator -----------------------------------------------------------
    def apply_np(self, u: np.ndarray) -> np.ndarray:
        acc = _sum_at(self.tgt, self.edge_w * u[self.src], self.n)
        return self.c * (acc - self.wsum * u)

    def apply(self, u: torch.Tensor, layout: str = "auto") -> torch.Tensor:
        """L(u) on u's device, in u's dtype, by ``layout`` (see the module
        docstring); ``windowed`` permutes in and inverts out."""
        if layout == "auto":
            layout = self.choose_layout()
        if layout == "offsets":
            return self.offset_plan().for_dtype(u.dtype, u.device).L(u)
        if layout == "windowed":
            return self.windowed_plan().for_dtype(u.dtype, u.device).L(u)
        if layout == "ell":
            col, w = self._ell()
            acc = torch.sum(self._on("ell_w", w, u) * u[self._on("ell_col", col, u,
                                                                  torch.int64)], dim=1)
        elif layout == "edges":
            vals = self._on("edge_w", self.edge_w, u) * u[self._on("src", self.src, u,
                                                                   torch.int64)]
            acc = torch.zeros_like(u).index_add_(0, self._on("tgt", self.tgt, u, torch.int64),
                                                 vals)
        else:
            raise ValueError(f"unknown layout {layout!r}; one of auto, offsets, windowed, "
                             "ell, edges")
        return self._on("c", self.c, u) * (acc - self._on("wsum", self.wsum, u) * u)

    # -- manufactured solution (product of sines at the node coords) --------
    def spatial_profile(self) -> np.ndarray:
        TWO_PI = 2.0 * np.pi
        return np.prod(np.sin(TWO_PI * self.points), axis=1)

    def source_parts(self):
        g = self.spatial_profile()
        return g, self.apply_np(g)

    def manufactured_solution(self, t: int) -> np.ndarray:
        return np.cos(2.0 * np.pi * (t * self.dt)) * self.spatial_profile()


class UnstructuredSolver:
    """Forward-Euler solver on a point cloud, the grid solvers' contract:
    ``test_init`` + ``do_work`` + ``error_l2/#points <= 1e-6``.

    ``backend="oracle"`` is the NumPy float64 loop; ``"torch"`` runs on the
    operator's device in ``dtype`` (float64 on the CPU, float32 on the card
    by default) with the layout ``layout`` (``auto``: the operator's policy,
    resolved once).  The windowed layout keeps the state in Morton order for
    the whole solve: one permute in, one out."""

    BACKENDS = ("oracle", "torch")

    def __init__(self, op: UnstructuredNonlocalOp, nt: int, backend: str = "torch",
                 layout: str = "auto", checkpoint_path: str | None = None,
                 ncheckpoint: int = 0, superstep: int = 1, dtype=None):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {self.BACKENDS}")
        if checkpoint_path or ncheckpoint:
            raise ValueError("checkpointing is not ported yet to nonlocalheatequation_torch "
                             "(checkpoint_path/ncheckpoint)")
        if int(superstep) > 1:
            raise ValueError("superstep > 1 is not ported yet to nonlocalheatequation_torch "
                             "(it needs the sharded offsets operator, ShardedUnstructuredOp, "
                             "of the distributed slice)")
        self.op = op
        self.nt = int(nt)
        self.backend = backend
        self.layout = layout
        self.dtype = resolve_dtype(dtype, op.device)
        self.t0 = 0
        self.test = False
        self.u0 = np.zeros(op.n)
        self.u = None
        self.error_l2 = 0.0
        self.error_linf = 0.0

    def test_init(self):
        self.test = True
        self.u0 = self.op.spatial_profile()

    def input_init(self, values):
        self.test = False
        self.u0 = np.asarray(values, np.float64).reshape(self.op.n)

    def do_work(self) -> np.ndarray:
        op = self.op
        g, lg = op.source_parts() if self.test else (None, None)
        if self.backend == "oracle":
            u = self.u0.copy()
            for t in range(self.t0, self.nt):
                du = op.apply_np(u)
                if self.test:
                    du = du + source_at(g, lg, t, op.dt)
                u = u + op.dt * du
        else:
            u = self._run_torch(g, lg)
        self.u = u
        if self.test:
            d = u - op.manufactured_solution(self.nt)
            self.error_l2 = float(np.sum(d * d))
            self.error_linf = float(np.max(np.abs(d))) if d.size else 0.0
        return u

    def _run_torch(self, g, lg):
        op, dtype, dev = self.op, self.dtype, self.op.device
        layout = op.choose_layout() if self.layout == "auto" else self.layout
        ex = op.windowed_plan().for_dtype(dtype, dev) if layout == "windowed" else None
        perm = ex.perm.cpu().numpy() if ex is not None else None
        u = torch.as_tensor(self.u0 if perm is None else self.u0[perm]).to(dev, dtype)
        if self.test:
            gd, lgd = ((g, lg) if perm is None else (g[perm], lg[perm]))
            gd = torch.as_tensor(gd).to(dev, dtype)
            lgd = torch.as_tensor(lgd).to(dev, dtype)
        for t in range(self.t0, self.nt):
            du = ex.L_perm(u) if ex is not None else op.apply(u, layout=layout)
            if self.test:
                du = du + source_at(gd, lgd, t, op.dt)
            u = u + op.dt * du
        if ex is not None:
            u = u[ex.rank]
        return u.cpu().numpy()
