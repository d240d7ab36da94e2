"""Domain decomposition, the reference's offline partitioning toolchain —
the port's own copy of ``nonlocalheatequation_tpu/utils/decompose.py``
(NumPy only, so the port partitions without importing the JAX package; both
give the same partition map for the same mesh).

Pipeline parity with src/domain_decomposition.cpp:52-195, redesigned to be
dependency-free: the GMSH C++ API becomes utils/gmsh.py, and METIS's
``METIS_PartMeshDual`` becomes the native RCB + dual-graph-refinement library
(native/partition.cc, loaded via ctypes when ``make -C native`` has built
it) with a pure-NumPy fallback of identical semantics — BOTH halves:
:func:`rcb_numpy` mirrors the native RCB and :func:`refine_cut_numpy` mirrors
the native ``refine_cut`` move/swap passes element for element, so an
unbuilt ``native/`` tree degrades only in speed, never in cut quality.
:data:`PARTITIONER` names the one that runs.

Steps (mirroring the reference):
  1. read the .msh, find the quad elements (type 3),
  2. infer dh from the first quad's first two nodes and the bounding box
     (domain_decomposition.cpp:99-121), mx = round((maxx-minx)/dh),
  3. validate the coarse tile sizes divide (mx, my); npx = mx // size_x,
  4. nparts < 2: every tile -> owner 0 (the reference's METIS FPE bypass,
     domain_decomposition.cpp:169-170); else partition the npx x npy coarse
     grid into nparts balanced contiguous regions (dual-graph ncommon=1,
     i.e. 8-neighbor adjacency, domain_decomposition.cpp:185-187),
  5. produce a PartitionMap (header "mx/npx my/npy npx npy dh").

The map's owner ids become the elastic executor's initial tile placement
(parallel/elastic.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from nonlocalheatequation_torch.utils.gmsh import MshData, read_msh
from nonlocalheatequation_torch.utils.native import load_native_lib
from nonlocalheatequation_torch.utils.partition_map import PartitionMap


def _load_native():
    lib = load_native_lib("libpartition.so", ("partition_rcb", "refine_cut"))
    if lib is None:
        return None
    lib.partition_rcb.restype = ctypes.c_int32
    lib.partition_rcb.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.refine_cut.restype = ctypes.c_int64
    lib.refine_cut.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    return lib


_native_lib = _load_native()

#: which partitioner :func:`partition_coarse_grid` runs: "native" or "numpy"
PARTITIONER = "numpy" if _native_lib is None else "native"


def rcb_numpy(xy: np.ndarray, nparts: int) -> np.ndarray:
    """Pure-NumPy recursive coordinate bisection, same semantics as the
    native partition_rcb (balanced to +-1, longer-axis median splits,
    deterministic index tie-break)."""
    n = xy.shape[0]
    parts = np.zeros(n, dtype=np.int32)

    def rec(elems: np.ndarray, part0: int, k: int):
        if k <= 1:
            parts[elems] = part0
            return
        box = xy[elems]
        axis = 0 if np.ptp(box[:, 0]) >= np.ptp(box[:, 1]) else 1
        nleft = k // 2
        mid = int(len(elems) * nleft / k)
        order = np.lexsort((elems, xy[elems, axis]))
        elems = elems[order]
        rec(elems[:mid], part0, nleft)
        rec(elems[mid:], part0 + nleft, k - nleft)

    rec(np.arange(n, dtype=np.int64), 0, nparts)
    return parts


def refine_cut_numpy(xadj: np.ndarray, adj: np.ndarray, nparts: int,
                     parts: np.ndarray, npasses: int = 8) -> int:
    """Greedy edge-cut refinement: the NumPy port of ``refine_cut``
    (native/partition.cc), bit-for-bit the same iteration order, donor
    guard, and tie-breaks — the two paths produce IDENTICAL partitions
    (pinned by test), so the cut-quality contract no longer depends on
    whether ``make -C native`` has run.  Mutates ``parts`` in place and
    returns moves + swaps made."""
    n = len(parts)
    size = np.bincount(parts, minlength=nparts).astype(np.int64)
    cap = n // nparts + 1
    floor = n // nparts
    moves = 0

    def local_cut(i):
        return int(np.sum(parts[adj[xadj[i]:xadj[i + 1]]] != parts[i]))

    for _ in range(npasses):
        pass_moves = 0
        # MOVE phase: relocate a boundary element to the neighboring part
        # with the most adjacent elements (strict gain, balance kept)
        for i in range(n):
            cur = parts[i]
            if size[cur] - 1 < floor:  # donor guard: never empty a part
                continue
            gain = np.bincount(parts[adj[xadj[i]:xadj[i + 1]]],
                               minlength=nparts)
            best = cur
            for q in range(nparts):
                if q != cur and size[q] < cap and gain[q] > gain[best]:
                    best = q
            if best != cur and gain[best] > gain[cur]:
                parts[i] = best
                size[cur] -= 1
                size[best] += 1
                moves += 1
                pass_moves += 1
        # SWAP phase: exchange adjacent cross-part pairs when the combined
        # cut strictly drops (lives at exact balance, where the move
        # phase's donor guard blocks everything)
        for i in range(n):
            for e in range(xadj[i], xadj[i + 1]):
                j = adj[e]
                if j <= i or parts[i] == parts[j]:
                    continue
                before = local_cut(i) + local_cut(j)
                parts[i], parts[j] = parts[j], parts[i]
                after = local_cut(i) + local_cut(j)
                if after < before:
                    moves += 1
                    pass_moves += 1
                else:
                    parts[i], parts[j] = parts[j], parts[i]
        if not pass_moves:
            break
    return moves


def dual_graph_csr(npx: int, npy: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR adjacency of the coarse-grid dual graph with METIS ncommon=1
    semantics: tiles sharing at least one node are adjacent (8-neighbor)."""
    xadj = [0]
    adj: list[int] = []
    for idy in range(npy):
        for idx in range(npx):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dx == 0 and dy == 0:
                        continue
                    jx, jy = idx + dx, idy + dy
                    if 0 <= jx < npx and 0 <= jy < npy:
                        adj.append(jy * npx + jx)
            xadj.append(len(adj))
    return np.asarray(xadj, np.int64), np.asarray(adj, np.int64)


def partition_coarse_grid(npx: int, npy: int, nparts: int) -> np.ndarray:
    """(npx, npy) owner ids for the coarse tile grid, [idx, idy]-indexed.

    nparts < 2 short-circuits to all-zeros exactly like the reference
    (domain_decomposition.cpp:169-170).
    """
    assignment = np.zeros((npx, npy), dtype=np.int64)
    if nparts < 2:
        return assignment
    # centroids in (idx, idy) flat row-major order over idy-major enumeration
    ids = np.arange(npx * npy)
    xy = np.stack([(ids % npx) + 0.5, (ids // npx) + 0.5], axis=1).astype(np.float64)
    if _native_lib is not None:
        parts = np.zeros(npx * npy, dtype=np.int32)
        if _native_lib.partition_rcb(npx * npy, np.ascontiguousarray(xy),
                                     nparts, parts) != 0:
            raise RuntimeError("native partition_rcb failed")
        xadj, adj = dual_graph_csr(npx, npy)
        _native_lib.refine_cut(npx * npy, xadj, adj, nparts, parts, 8)
    else:
        parts = rcb_numpy(xy, nparts)
        xadj, adj = dual_graph_csr(npx, npy)
        refine_cut_numpy(xadj, adj, nparts, parts)
    assignment[ids % npx, ids // npx] = parts
    return assignment


def infer_structured_grid(msh: MshData) -> tuple[int, int, float]:
    """(mx, my, dh) of the structured quad mesh, the reference's recipe.

    dh is the coordinate difference between the first quad's first two nodes
    (max of x-diff and |y-diff|, domain_decomposition.cpp:99-104); mx, my
    come from the quad-node bounding box (106-121).
    """
    qc = msh.quad_coords()
    if qc.shape[0] == 0:
        raise ValueError("mesh contains no quadrangle (type 3) elements")
    first = qc[0]
    # abs() on both axes (the reference uses the SIGNED x-difference,
    # domain_decomposition.cpp:99-104, which silently depends on GMSH's
    # corner ordering; taking |.| accepts any valid corner order and agrees
    # with the reference on every mesh the reference itself accepts)
    dh = max(abs(first[0, 0] - first[1, 0]), abs(first[0, 1] - first[1, 1]))
    if dh <= 0:
        raise ValueError(f"could not infer a positive dh (got {dh})")
    xs, ys = qc[..., 0], qc[..., 1]
    mx = round(float(xs.max() - xs.min()) / dh)
    my = round(float(ys.max() - ys.min()) / dh)
    return int(mx), int(my), float(dh)


def decompose(mesh: str | MshData, nparts: int, coarse_x: int, coarse_y: int) -> PartitionMap:
    """Full pipeline: .msh (path or already-parsed MshData) -> PartitionMap.

    ``coarse_x, coarse_y`` are the per-tile sizes the reference prompts for on
    stdin (domain_decomposition.cpp:138-156); they must divide the inferred
    mesh sizes.
    """
    if isinstance(mesh, str):
        mesh = read_msh(mesh)
    mx, my, dh = infer_structured_grid(mesh)
    if coarse_x < 1 or mx % coarse_x != 0:
        raise ValueError(
            f"mesh size x ({mx}) not divisible by coarse grain size {coarse_x}")
    if coarse_y < 1 or my % coarse_y != 0:
        raise ValueError(
            f"mesh size y ({my}) not divisible by coarse grain size {coarse_y}")
    npx, npy = mx // coarse_x, my // coarse_y
    assignment = partition_coarse_grid(npx, npy, nparts)
    return PartitionMap(mx // npx, my // npy, npx, npy, dh, assignment)


def edge_cut(assignment: np.ndarray) -> int:
    """Dual-graph edge cut of a coarse-grid partition — the quantity
    METIS_PartMeshDual minimizes (domain_decomposition.cpp:185-187,
    ncommon=1 -> 8-neighbor adjacency).  ``assignment`` is the (npx, npy)
    owner grid; returns the number of adjacent tile pairs with different
    owners (each undirected pair counted once)."""
    a = np.asarray(assignment)
    npx, npy = a.shape
    cut = 0
    for dx, dy in ((1, 0), (0, 1), (1, 1), (1, -1)):
        xs, xt = slice(0, npx - dx), slice(dx, npx)
        if dy >= 0:
            ys, yt = slice(0, npy - dy), slice(dy, npy)
        else:
            ys, yt = slice(-dy, npy), slice(0, npy + dy)
        cut += int((a[xs, ys] != a[xt, yt]).sum())
    return cut
