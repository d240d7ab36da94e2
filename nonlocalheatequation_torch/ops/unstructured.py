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

:class:`UnstructuredSolver` checkpoints and resumes (utils/checkpoint.py),
in the original node order whatever the layout.

:class:`ShardedUnstructuredOp` evaluates L over a 1D mesh of S devices
(virtual devices allowed, parallel/mesh.py): equal contiguous node blocks,
edges partitioned by their target's block, with the JAX package's halo forms
(``export``, ``gather``, ``auto``) or the ring-exchanged diagonal (offsets)
form, and the offsets form's K-step superstep (``UnstructuredSolver(...,
superstep=K)``).  The JAX package's ``NLHEAT_WINDOWED``,
``NLHEAT_OFFSETS`` and ``NLHEAT_WINDOWED_BUDGET_MB`` knobs are not read:
nothing in the port sets them, and the budget is a constant.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nonlocalheatequation_torch.ops.nonlocal_op import source_at
from nonlocalheatequation_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    device_list,
    first_local,
    map_blocks,
)
from nonlocalheatequation_torch.parallel.multihost import (
    Remote,
    RemoteDevice,
    exchange,
    gather_blocks,
)
from nonlocalheatequation_torch.utils.checkpoint import CheckpointMixin
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


def _ring_exchange(blocks: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """[left band | own block | right band] of every block this rank owns
    of a 1D ring of blocks (JAX ``_ring_exchange``, ``:382``): the ``lo``
    last entries of the block before, the ``hi`` first of the block after,
    copied onto each block's device, or sent between ranks in one
    ``batch_isend_irecv`` (parallel/multihost.exchange).  The ring wraps, so
    the bands that reach past the ends of the domain are garbage: the
    per-step offsets form multiplies them by zero weights, the superstep
    masks them."""
    S = len(blocks)
    bands, sends, recvs, keys = {}, [], [], []
    for s in range(S):
        for side, width in ((-1, lo), (1, hi)):
            if not width:
                continue
            dst, src = blocks[s], blocks[(s + side) % S]
            if isinstance(dst, Remote) and isinstance(src, Remote):
                continue
            tag = 2 * s + (side > 0)
            if isinstance(src, Remote):
                recvs.append((src.rank, (width,), dst.dtype, dst.device, tag))
                keys.append((s, side))
                continue
            # the band from the LEFT neighbour is its tail, from the RIGHT its head
            band = src[src.shape[0] - width:] if side < 0 else src[:width]
            if isinstance(dst, Remote):
                sends.append((dst.rank, band, tag))
            else:
                bands[(s, side)] = band.to(dst.device)
    bands.update(zip(keys, exchange(sends, recvs), strict=True))
    out = blocks.copy()  # other ranks' positions keep their placeholders
    for s in range(S):
        mine = blocks[s]
        if isinstance(mine, Remote):
            continue
        parts = ([bands[(s, -1)]] if lo else []) + [mine] + ([bands[(s, 1)]] if hi else [])
        out[s] = torch.cat(parts) if len(parts) > 1 else mine
    return out


class ShardedUnstructuredOp:
    """Multi-device evaluation of an :class:`UnstructuredNonlocalOp` — JAX
    ``ShardedUnstructuredOp`` (``ops/unstructured.py:401-812``).

    The nodes are split into S equal contiguous index blocks of B over a 1D
    mesh (axis ``p``; the last block zero-padded); the edge list is
    partitioned by its target's block, so every sum is local to a block.
    Each rank holds the blocks it owns (parallel/mesh.py); a value moved
    between virtual devices of one device is a copy on that device, between
    ranks a ``torch.distributed`` message (the ring's bands) or all-gather
    (the exports, the gathered state).  The halo has
    the JAX package's forms (``halo=`` "auto"/"export"/"gather"):

    * **export**: each block exports only its nodes that another block's
      edges read (index sets built once); the state a block reads is [its
      own B | every block's exports], S*Emax values instead of S*B.
    * **gather**: every block reads the whole state.

    "auto" picks export when the exports are under half the full gather
    (``halo_comm_ratio``).  Both read the same addends in the same order,
    so they are bitwise equal.  Each block sums its rows as padded rows
    (each target's edges in the global edge order, zero-weight padding to
    the block's widest row) one column at a time, left to right: the
    order ``segment_sum`` and ``index_add_`` add in on the CPU, and an order
    fixed on the card, where ``index_add_`` adds with atomics in no fixed
    order.  So a block's sums are the single-device ``edges`` layout's on
    the CPU bitwise, and on every device the same whatever S.

    ``layout="offsets"`` (picked by ``layout="auto"`` with ``halo="auto"``
    when the cloud's src-tgt offsets cover every edge and the bands fit one
    hop) keeps each block's (|O|, B) slice of the dense diagonals and
    exchanges only pad_lo/pad_hi-wide bands with its ring neighbours
    (:func:`_ring_exchange`), summing the diagonals in the single-device
    offsets layout's order: bitwise that layout.  Only this form runs the
    K-step superstep (:meth:`make_superstep`).

    The operator duck-types the single-device surface the solver reads
    (``n``, ``dt``, ``apply_np``, ``spatial_profile``, ``source_parts``,
    ``manufactured_solution``); :meth:`apply` takes and returns the global
    (n,) vector, :meth:`apply_blocks` the state's blocks
    (:meth:`to_blocks`/:meth:`from_blocks`)."""

    def __init__(self, op: UnstructuredNonlocalOp, mesh: Mesh | None = None, devices=None,
                 halo: str = "auto", layout: str = "auto"):
        self.inner = op
        self.n, self.dt = op.n, op.dt
        if mesh is None:
            devices = list(devices if devices is not None else device_list(op.device))
            mesh = create_mesh(("p",), (len(devices),), devices)
        if mesh.axis_names != ("p",):
            raise ValueError(f"the mesh's axes {mesh.axis_names} are not ('p',)")
        self.mesh = mesh
        self.devices = list(mesh.devices.flat)
        if not mesh.local_devices:
            raise ValueError(f"this rank owns no position of the mesh {mesh.shape}")
        self.device = mesh.local_devices[0]
        S = int(mesh.size)
        self.S = S
        B = -(-op.n // S)  # the block size (the last block zero-padded)
        self.B = B
        self.pad = S * B - op.n
        # (name, shard, dtype) -> a tensor on the shard's device; and
        # ("superstep", K, dtype, test) -> make_superstep's block function
        self._tensors: dict = {}

        if layout not in ("auto", "offsets", "edges"):
            raise ValueError(f"layout must be auto/offsets/edges, got {layout!r}")
        if layout == "offsets" and halo != "auto":
            raise ValueError(
                "layout='offsets' replaces the edge halo machinery; it "
                f"cannot honor halo={halo!r} — drop one of the two")
        if layout == "offsets" and not len(op.tgt):
            raise ValueError("layout='offsets' needs a non-empty edge list")
        if layout == "auto" and halo != "auto":
            # an explicit halo asks for the edge layout's halo machinery
            layout = "edges"
        if layout in ("auto", "offsets") and len(op.tgt):
            from nonlocalheatequation_torch.ops.windowed import offset_stats

            cov, _, _ = offset_stats(op.tgt, op.src, op.n)
            plan = op.offset_plan() if cov >= 1.0 else None
            fits = (plan is not None and plan.coverage >= 1.0
                    and plan.pad_lo <= B and plan.pad_hi <= B)
            if layout == "offsets" and not fits:
                raise ValueError(
                    "layout='offsets' needs full offset coverage and "
                    f"one-hop halos (coverage {cov:.4f}, pads "
                    f"{getattr(plan, 'pad_lo', '?')}/"
                    f"{getattr(plan, 'pad_hi', '?')} vs block {B})")
            if fits:
                self._init_offsets(plan)
                return
        self.layout = "edges"

        # edges by target block; within a block (and a target) the global
        # (target, source) order
        shard_of = op.tgt // B
        # export sets: the nodes of block r that another block's edges read
        exports = []
        for r in range(S):
            remote = (op.src // B == r) & (shard_of != r)
            exports.append(np.unique(op.src[remote]))
        Emax = max(1, max(len(e) for e in exports))
        self.halo_comm_ratio = S * Emax / float(S * B)
        if halo not in ("auto", "export", "gather"):
            raise ValueError(f"halo must be auto/export/gather, got {halo!r}")
        if halo == "auto":
            halo = "export" if (S > 1 and 2 * S * Emax <= S * B) else "gather"
        self.halo_mode = halo
        self.Emax = Emax
        if halo == "export":
            self._exp_idx = np.zeros((S, Emax), np.int64)
            slot = np.zeros(S * B, np.int64)  # global node -> slot in its owner's exports
            for r, e in enumerate(exports):
                self._exp_idx[r, :len(e)] = e - r * B
                slot[e] = np.arange(len(e))
        # padded rows per block: (B, width) columns into the state the block
        # reads, and weights (zero in the padding)
        self._cols, self._ws = [], []
        for s in range(S):
            m = shard_of == s
            tl = op.tgt[m].astype(np.int64) - s * B
            srcs = op.src[m].astype(np.int64)
            if halo == "export":
                owner = srcs // B
                srcs = np.where(owner == s, srcs - s * B, B + owner * Emax + slot[srcs])
            deg = np.bincount(tl, minlength=B)
            width = max(1, int(deg.max()) if len(tl) else 1)
            starts = np.zeros(B + 1, np.int64)
            np.cumsum(deg, out=starts[1:])
            pos = np.arange(len(tl)) - starts[tl]
            col = np.zeros((B, width), np.int64)
            w = np.zeros((B, width), np.float64)
            col[tl, pos] = srcs
            w[tl, pos] = op.edge_w[m]
            self._cols.append(col)
            self._ws.append(w)
        self._c = self._blk(op.c)
        self._wsum = self._blk(op.wsum)

    def _blk(self, x) -> np.ndarray:
        """An (n,) host field as (S, B) with zero padding."""
        xp = np.zeros(self.S * self.B, np.float64)
        xp[:self.n] = x
        return xp.reshape(self.S, self.B)

    def _init_offsets(self, plan) -> None:
        """The sharded diagonal form (JAX ``:592-638``): block s keeps the
        (|O|, B) slice of every diagonal's weights; a step exchanges the
        pad_lo/pad_hi bands with its ring neighbours and sums static slices.
        The bands wrapped in at the domain's ends meet zero weights: no edge
        crosses the domain's boundary."""
        op, S, B = self.inner, self.S, self.B
        self.layout = "offsets"
        self.halo_mode = "offsets-ppermute"
        self._plan = plan
        self.halo_comm_ratio = (plan.pad_lo + plan.pad_hi) / float(S * B)
        w3 = np.zeros((len(plan.offs), S * B), np.float64)
        w3[:, :op.n] = plan.W
        self._w3 = w3.reshape(len(plan.offs), S, B).transpose(1, 0, 2)  # (S, |O|, B)
        self._c = self._blk(op.c)
        self._wsum = self._blk(op.wsum)

    def _on(self, name: str, s: int, array, dtype) -> torch.Tensor:
        """Block ``s``'s host array ``array`` on its device in ``dtype``,
        converted once."""
        key = (name, s, dtype)
        t = self._tensors.get(key)
        if t is None:
            t = self._tensors[key] = torch.as_tensor(np.ascontiguousarray(array)).to(
                device=self.devices[s], dtype=dtype)
        return t

    # -- the state's blocks ---------------------------------------------------
    def to_blocks(self, u, dtype=None) -> np.ndarray:
        """The global (n,) state (NumPy or a tensor) as an object array of S
        (B,) blocks on the mesh, zero-padded, in ``dtype`` (default ``u``'s)."""
        x = torch.as_tensor(u)
        xp = x.to(x.dtype if dtype is None else dtype)
        if self.pad:
            xp = torch.cat([xp, xp.new_zeros(self.pad)])
        out = np.empty(self.S, dtype=object)
        for s in range(self.S):
            d = self.devices[s]
            out[s] = (Remote(d.rank) if isinstance(d, RemoteDevice)
                      else xp[s * self.B:(s + 1) * self.B].to(d).contiguous())
        return out

    def from_blocks(self, blocks: np.ndarray, device=None) -> torch.Tensor:
        """The global (n,) state on ``device`` (default this rank's first
        block's), on every rank."""
        device = first_local(blocks).device if device is None else device
        return torch.cat([b.to(device) for b in gather_blocks(blocks)])[:self.n]

    def apply_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """L(u) of the state's blocks, block by block (this rank's)."""
        dtype = first_local(blocks).dtype
        out = blocks.copy()  # other ranks' positions keep their placeholders
        mine_s = [s for s in range(self.S) if not isinstance(blocks[s], Remote)]
        if self.layout == "offsets":
            plan = self._plan
            up = _ring_exchange(blocks, plan.pad_lo, plan.pad_hi)
            for s in mine_s:
                mine, w3 = blocks[s], self._on("w3", s, self._w3[s], dtype)
                acc = torch.zeros_like(mine)
                for j, o in enumerate(plan.offs):
                    start = plan.pad_lo + o
                    acc = acc + w3[j] * up[s][start:start + self.B]
                out[s] = self._on("c", s, self._c[s], dtype) * (
                    acc - self._on("wsum", s, self._wsum[s], dtype) * mine)
            return out
        if self.halo_mode == "export":
            exports = blocks.copy()
            for r in mine_s:
                exports[r] = blocks[r][self._on("exp", r, self._exp_idx[r], torch.int64)]
            sent = gather_blocks(exports)  # every block's exports, on every rank
        else:
            state = gather_blocks(blocks)  # the whole state, on every rank
        for s in mine_s:
            mine = blocks[s]
            if self.halo_mode == "export":
                frame = torch.cat([mine] + [e.to(mine.device) for e in sent])
            else:
                frame = torch.cat([b.to(mine.device) for b in state])
            vals = (self._on("w", s, self._ws[s], dtype)
                    * frame[self._on("col", s, self._cols[s], torch.int64)])
            acc = torch.zeros_like(mine)
            for j in range(vals.shape[1]):  # the padded rows, a column at a time
                acc = acc + vals[:, j]
            out[s] = self._on("c", s, self._c[s], dtype) * (
                acc - self._on("wsum", s, self._wsum[s], dtype) * mine)
        return out

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """L(u) of the global (n,) tensor ``u``, returned on ``u``'s device."""
        return self.from_blocks(self.apply_blocks(self.to_blocks(u)), u.device)

    # -- the single-device operator's surface --------------------------------
    def apply_np(self, u):
        return self.inner.apply_np(u)

    def spatial_profile(self):
        return self.inner.spatial_profile()

    def source_parts(self):
        return self.inner.source_parts()

    def manufactured_solution(self, t: int):
        return self.inner.manufactured_solution(t)

    # -- the K-step superstep (offsets form) ---------------------------------
    def superstep_fits(self, ksteps: int) -> bool:
        """Can the K-step block run?  The offsets layout only (residual edges
        would need arbitrary cross-block reads), the K-wide bands one hop
        (K*pad <= block)."""
        if self.layout != "offsets" or ksteps < 2:
            return False
        plan = self._plan
        return ksteps * plan.pad_lo <= self.B and ksteps * plan.pad_hi <= self.B

    def superstep_check(self, ksteps: int) -> None:
        """The one refusal of an unfit K (the constructor and the builder
        share it)."""
        if self.superstep_fits(ksteps):
            return
        if ksteps < 2:
            raise ValueError(
                f"superstep needs K >= 2 (got {ksteps}); K=1 IS the "
                "per-step path")
        plan = self._plan if self.layout == "offsets" else None
        raise ValueError(
            f"superstep {ksteps} does not fit the sharded offsets form "
            f"(layout={self.layout!r}, pads "
            f"{getattr(plan, 'pad_lo', '?')}/"
            f"{getattr(plan, 'pad_hi', '?')}, block {self.B}): needs "
            "the offsets layout and K*pad <= block")

    def make_superstep(self, ksteps: int, dtype, test: bool):
        """The communication-avoiding K-step block of the offsets form (JAX
        ``:701``): ONE (K*pad_lo, K*pad_hi)-wide ring exchange a K steps, then
        K local levels on shrinking regions (the grid solvers' superstep
        schedule in the 1D diagonal domain).  Each block's extended slices of
        the static fields (diagonal weights, c, wsum, sources) are cut once
        here; only the state rides the ring.  Positions outside the domain
        (the ring's wrapped bands, the padding tail) are zeroed on entry and
        after every intermediate level.  Each level runs the per-step
        form's elementwise program, so K levels are bitwise K per-step steps.

        Returns ``block_fn(blocks, t) -> blocks`` advancing the state's
        blocks K steps from step ``t`` (the JAX method also returns its
        device arguments, which the jit takes; here ``block_fn`` holds them),
        built once per (K, dtype, test)."""
        K = int(ksteps)
        self.superstep_check(K)
        key = ("superstep", K, dtype, bool(test))
        if key not in self._tensors:
            self._tensors[key] = self._superstep(K, dtype, test)
        return self._tensors[key]

    def _superstep(self, K: int, dtype, test: bool):
        """:meth:`make_superstep`'s builder."""
        plan = self._plan
        pad_lo, pad_hi, offs = plan.pad_lo, plan.pad_hi, plan.offs
        S, B, n = self.S, self.B, self.n
        PL, PH = K * pad_lo, K * pad_hi
        ext = PL + B + PH

        def ext_blocks(vec):
            """An (n,) global host field -> (S, ext) extended slices, zero
            beyond the domain."""
            vp = np.zeros(PL + S * B + PH, np.float64)
            vp[PL:PL + n] = np.asarray(vec)
            return np.stack([vp[s * B:s * B + ext] for s in range(S)])

        Wg = np.zeros((len(offs), PL + S * B + PH), np.float64)
        Wg[:, PL:PL + n] = plan.W
        fields = {"w3x": np.stack([Wg[:, s * B:s * B + ext] for s in range(S)]),
                  "cx": ext_blocks(self.inner.c), "wsx": ext_blocks(self.inner.wsum)}
        if test:
            g, lg = self.inner.source_parts()
            fields.update(gx=ext_blocks(g), lgx=ext_blocks(lg))
        dev = [None if isinstance(self.devices[s], RemoteDevice) else
               {k: torch.as_tensor(v[s]).to(device=self.devices[s], dtype=dtype)
                for k, v in fields.items()} for s in range(S)]
        dt = self.dt

        def in_domain(start: int, length: int, device):
            idx = start + torch.arange(length, device=device)
            return (idx >= 0) & (idx < n)

        def block_fn(blocks, t):
            ring = _ring_exchange(blocks, PL, PH)
            out = ring.copy()  # other ranks' positions keep their placeholders
            for s in range(S):
                f = dev[s]
                if f is None:
                    continue
                gpos0 = s * B - PL  # the global index of the extended slice's first entry
                cur = ring[s]
                cur = torch.where(in_domain(gpos0, ext, cur.device), cur, torch.zeros_like(cur))
                for j in range(1, K + 1):
                    m_lo, m_hi = (K - j) * pad_lo, (K - j) * pad_hi
                    L = m_lo + B + m_hi
                    o0 = PL - m_lo  # this level's offset into the extended slices
                    acc = torch.zeros(L, dtype=cur.dtype, device=cur.device)
                    for jo, o in enumerate(offs):
                        acc = acc + f["w3x"][jo, o0:o0 + L] * cur[pad_lo + o:pad_lo + o + L]
                    center = cur[pad_lo:pad_lo + L]
                    du = f["cx"][o0:o0 + L] * (acc - f["wsx"][o0:o0 + L] * center)
                    if test:
                        du = du + source_at(f["gx"][o0:o0 + L], f["lgx"][o0:o0 + L],
                                            t + (j - 1), dt)
                    nxt = center + dt * du
                    if j < K:
                        nxt = torch.where(in_domain(gpos0 + o0, L, nxt.device), nxt,
                                          torch.zeros_like(nxt))
                    cur = nxt
                out[s] = cur
            return out

        return block_fn


class UnstructuredSolver(CheckpointMixin):
    """Forward-Euler solver on a point cloud, the grid solvers' contract:
    ``test_init`` + ``do_work`` + ``error_l2/#points <= 1e-6``.

    ``backend="oracle"`` is the NumPy float64 loop; ``"torch"`` runs on the
    operator's device in ``dtype`` (float64 on the CPU, float32 on the card
    by default) with the layout ``layout`` (``auto``: the operator's policy,
    resolved once).  The windowed layout keeps the state in Morton order for
    the whole solve: one permute in, one out, and one out for each
    checkpoint, which holds the original node order.

    On a :class:`ShardedUnstructuredOp` the state lives in the operator's
    blocks between checkpoint barriers (``layout`` does not apply: the
    operator owns its layout), and ``superstep=K > 1`` runs the offsets
    form's K-step blocks (:meth:`ShardedUnstructuredOp.make_superstep`), the
    remainder of each segment per step; K is refused wherever the schedule
    cannot engage (JAX ``:814-980``)."""

    BACKENDS = ("oracle", "torch")

    def __init__(self, op, nt: int, backend: str = "torch", layout: str = "auto",
                 checkpoint_path: str | None = None, ncheckpoint: int = 0,
                 superstep: int = 1, dtype=None):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {self.BACKENDS}")
        self.op = op
        self.nt = int(nt)
        self.backend = backend
        self.layout = layout
        self.dtype = resolve_dtype(dtype, op.device)
        self.checkpoint_path = checkpoint_path
        self.ncheckpoint = int(ncheckpoint)
        self.t0 = 0
        self.test = False
        self.u0 = np.zeros(op.n)
        self.u = None
        self.error_l2 = 0.0
        self.error_linf = 0.0
        # superstep K > 1: one (K*pad)-wide ring exchange a K steps on the
        # sharded offsets operator, refused anywhere it cannot engage
        self.ksteps = max(1, int(superstep))
        if self.ksteps > 1:
            if backend != "torch" or getattr(op, "superstep_check", None) is None:
                raise ValueError(
                    "superstep > 1 needs the torch backend on a "
                    "ShardedUnstructuredOp (offsets layout)")
            op.superstep_check(self.ksteps)  # the shared fit refusal

    def _ckpt_params(self) -> dict:
        """The point cloud's canonical parameters: eps is a per-point field
        here, so its mean and L2 stand for it."""
        inner = getattr(self.op, "inner", self.op)
        return dict(shape=[int(inner.n)], eps=float(np.mean(inner.eps)),
                    eps_l2=float(np.sum(inner.eps ** 2)), k=float(inner.k),
                    dt=float(self.op.dt), test=bool(self.test))

    @property
    def _grid_shape(self):
        return (self.op.n,)

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
                self._maybe_checkpoint(t, u)
        elif isinstance(op, ShardedUnstructuredOp):
            u = self._run_sharded(g, lg)
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
            if self._ckpt_due(t):
                self._maybe_checkpoint(t, u if ex is None else u[ex.rank])
        if ex is not None:
            u = u[ex.rank]
        return u.cpu().numpy()

    def _run_sharded(self, g, lg):
        """The sharded operator's loop: one runner call per segment between
        checkpoint barriers, the state in the operator's blocks within it."""
        op, dtype, K = self.op, self.dtype, self.ksteps
        srcs = (op.to_blocks(g, dtype), op.to_blocks(lg, dtype)) if self.test else None
        block_fn = None
        if K > 1:
            if not any(c >= K for _, c in self._ckpt_chunks()):
                # every segment shorter than K: no K-block could ever form
                raise RuntimeError(
                    f"superstep {K} cannot engage: every "
                    "segment between checkpoint barriers is shorter "
                    "than K (ncheckpoint/nt vs superstep); widen the "
                    "cadence or drop superstep")
            block_fn = op.make_superstep(K, dtype, self.test)

        def step(blocks, t):
            du = op.apply_blocks(blocks)
            if srcs is not None:
                du = map_blocks(lambda d, g, lg: d + source_at(g, lg, t, op.dt), du, *srcs)
            return map_blocks(lambda u, d: u + op.dt * d, blocks, du)

        def make_runner(count):
            def run(u, t0):
                blocks = op.to_blocks(u, dtype)
                nblocks = count // K if block_fn is not None else 0
                for i in range(nblocks):
                    blocks = block_fn(blocks, t0 + K * i)
                for t in range(t0 + nblocks * K, t0 + count):
                    blocks = step(blocks, t)
                return op.from_blocks(blocks)
            return run

        u = torch.as_tensor(self.u0).to(op.device, dtype)
        return self._run_chunked(u, make_runner).cpu().numpy()
