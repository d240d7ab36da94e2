"""Mesh registry: content-hashed point clouds as a serving dimension —
counterpart of ``nonlocalheatequation_tpu/serve/meshes.py``.

A mesh is stored once under the mesh directory, keyed by a content hash of
its node coordinates, its per-point horizon field and the derived edge
table; every ensemble case that names the hash (``EnsembleCase.mesh``,
serve/ensemble.py) resolves the stored cloud here.  The ``.npz`` format and
the hash are the JAX package's, so a mesh stored by either package resolves
in the other.

The mesh directory is private state (0700); uploads are validated
(:func:`validate_mesh`: bounds, finiteness, dtype).  :func:`gang_order` is
the node order for a sharded solve (ops/unstructured.ShardedUnstructuredOp).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from nonlocalheatequation_torch.utils.checkpoint import atomic_file

#: Env knob: the mesh directory.  ""/"0" = registry off, "1" = the
#: per-user default, anything else = an explicit directory.
MESH_DIR_ENV = "NLHEAT_MESH_DIR"

DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache", "nlheat", "meshes")

#: Upload bounds: the node count (``NLHEAT_MESH_MAX_NODES`` overrides) and
#: the request size the HTTP front door reads (serve/http.py).
MAX_NODES = 4_000_000
MAX_BODY_BYTES = 256 << 20


def mesh_dir_from_env() -> str | None:
    """The configured mesh directory, or None when the registry is off
    (unset/empty/``0``); ``1`` selects :data:`DEFAULT_DIR`."""
    raw = os.environ.get(MESH_DIR_ENV, "")
    if raw in ("", "0"):
        return None
    if raw == "1":
        return DEFAULT_DIR
    return raw


def max_nodes() -> int:
    return int(os.environ.get("NLHEAT_MESH_MAX_NODES") or MAX_NODES)


class UnknownMesh(KeyError):
    """A referenced mesh hash is not in the registry."""

    def __str__(self) -> str:  # KeyError repr-quotes its arg; keep the
        return self.args[0] if self.args else ""  # message readable


def validate_mesh(points, eps, vol=None):
    """Normalize + validate a mesh; returns ``(points, eps, vol)`` as f64
    arrays.  Raises ``ValueError`` with a one-line reason on anything
    malformed."""
    points = np.asarray(points, np.float64)
    if points.ndim != 2:
        raise ValueError(f"mesh points must be 2-D (n, d), got shape {points.shape}")
    n, d = points.shape
    if not 1 <= d <= 3:
        raise ValueError(f"mesh dimension must be 1..3, got {d}")
    if n < 2:
        raise ValueError(f"mesh needs at least 2 nodes, got {n}")
    if n > max_nodes():
        raise ValueError(f"mesh has {n} nodes, over the {max_nodes()} cap "
                         "(NLHEAT_MESH_MAX_NODES)")
    if not np.all(np.isfinite(points)):
        raise ValueError("mesh points contain non-finite values")
    eps = np.broadcast_to(np.asarray(eps, np.float64), (n,)).copy()
    if not np.all(np.isfinite(eps)) or not np.all(eps > 0):
        raise ValueError("eps field must be finite and > 0 everywhere")
    if vol is None:
        vol = np.ones(n)
    vol = np.broadcast_to(np.asarray(vol, np.float64), (n,)).copy()
    if not np.all(np.isfinite(vol)) or not np.all(vol > 0):
        raise ValueError("vol field must be finite and > 0 everywhere")
    return points, eps, vol


def mesh_hash(points, eps, tgt, src) -> str:
    """Content hash of (points, eps-field, edge table): sha256 over shapes
    and raw f64/int32 bytes, truncated to 16 hex chars (the JAX package's
    hash, character for character)."""
    h = hashlib.sha256()
    for a in (np.ascontiguousarray(points, np.float64), np.ascontiguousarray(eps, np.float64)):
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    for a in (np.ascontiguousarray(tgt, np.int32), np.ascontiguousarray(src, np.int32)):
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


class MeshStore:
    """Dir-backed registry of validated meshes, keyed by content hash."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, mhash: str) -> str:
        if not mhash or any(c not in "0123456789abcdef" for c in mhash):
            # a traversal-shaped "hash" must die here, not resolve to a path
            # outside the dir
            raise ValueError(f"malformed mesh hash {mhash!r}")
        return os.path.join(self.root, f"{mhash}.npz")

    def put(self, points, eps, vol=None) -> str:
        """Validate, hash, persist; returns the content hash.  Repeat
        uploads of the same content are idempotent (the existing file wins)."""
        from nonlocalheatequation_torch.ops.unstructured import build_edges

        points, eps, vol = validate_mesh(points, eps, vol)
        tgt, src = build_edges(points, eps)
        mhash = mesh_hash(points, eps, tgt, src)
        path = self._path(mhash)
        if not os.path.exists(path):
            os.makedirs(self.root, mode=0o700, exist_ok=True)
            with atomic_file(path, "wb") as f:
                np.savez(f, points=points, eps=eps, vol=vol, tgt=tgt.astype(np.int32),
                         src=src.astype(np.int32))
        return mhash

    def has(self, mhash: str) -> bool:
        try:
            return os.path.exists(self._path(mhash))
        except ValueError:
            return False

    def get(self, mhash: str) -> dict:
        """The stored arrays; :class:`UnknownMesh` (a KeyError) on an
        unknown hash."""
        path = self._path(mhash)
        if not os.path.exists(path):
            raise UnknownMesh(f"unknown mesh hash {mhash!r}")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def meta(self, mhash: str) -> dict:
        d = self.get(mhash)
        return {"hash": mhash, "nodes": int(len(d["points"])), "dim": int(d["points"].shape[1]),
                "edges": int(len(d["tgt"]))}


def resolve_mesh_store(mesh_dir=None) -> MeshStore | None:
    """A :class:`MeshStore` from an explicit dir or the env knob; None when
    the registry is off."""
    root = mesh_dir if mesh_dir is not None else mesh_dir_from_env()
    return MeshStore(root) if root else None


# -- mesh hash -> operator (the engine's _make_op hook) ---------------------

#: (realpath(root), hash, k, dt, device) -> UnstructuredNonlocalOp; ops are
#: immutable once built, and a mesh bucket touches its op per chunk
_OP_CACHE: dict = {}
_OP_CACHE_CAP = 8
#: (realpath(root), hash) -> the stored edge table, once the rebuild has
#: been checked against it (one edge build per mesh, not per physics)
_EDGES: dict = {}


def _verified_edges(store: MeshStore, mhash: str, d: dict):
    key = (os.path.realpath(store.root), mhash)
    edges = _EDGES.get(key)
    if edges is None:
        from nonlocalheatequation_torch.ops.unstructured import build_edges

        tgt, src = build_edges(d["points"], d["eps"])
        if not np.array_equal(tgt, d["tgt"]) or not np.array_equal(src, d["src"]):
            raise RuntimeError(f"mesh {mhash}: rebuilt edge table disagrees with the stored "
                               "one — edge-builder drift; re-upload the mesh")
        while len(_EDGES) >= _OP_CACHE_CAP:
            _EDGES.pop(next(iter(_EDGES)))
        edges = _EDGES[key] = (tgt, src)
    return edges


def get_mesh_op(mhash: str, k: float, dt: float, mesh_dir=None, device=None):
    """The :class:`UnstructuredNonlocalOp` for a stored mesh under the given
    physics, on ``device`` (the card unless ``"cpu"``).  The stored edge
    table is part of the hash; the first use of a mesh rebuilds it and
    refuses a mismatch."""
    from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp
    from nonlocalheatequation_torch.utils.devices import resolve_device

    store = resolve_mesh_store(mesh_dir)
    if store is None:
        raise RuntimeError("mesh-keyed case but no mesh registry configured "
                           f"({MESH_DIR_ENV} is off)")
    device = resolve_device(device)
    key = (os.path.realpath(store.root), mhash, float(k), float(dt), str(device))
    op = _OP_CACHE.get(key)
    if op is None:
        d = store.get(mhash)
        op = UnstructuredNonlocalOp(d["points"], d["eps"], k=float(k), dt=float(dt),
                                    vol=d["vol"], device=device,
                                    edges=_verified_edges(store, mhash, d))
        while len(_OP_CACHE) >= _OP_CACHE_CAP:
            _OP_CACHE.pop(next(iter(_OP_CACHE)))
        _OP_CACHE[key] = op
    return op


# -- gang placement: partition_coarse_grid feeds the sharded operator -------------------

def gang_order(points: np.ndarray, ndevices: int, coarse: int = 16) -> np.ndarray:
    """A node permutation that makes index-contiguous equal blocks spatially
    compact (JAX ``serve/meshes.py:221-248``): bin the nodes onto a ``coarse
    x coarse`` tile grid over their bounding box, partition the tiles with
    the refined RCB cuts of :func:`utils.decompose.partition_coarse_grid`
    (the reference's decomposition, src/domain_decomposition.cpp:157-195),
    and order the nodes by (owner part, tile, index).  Fed the permuted
    cloud, ``ShardedUnstructuredOp`` places each part's nodes on one device,
    so the ring halo carries only true cut edges."""
    from nonlocalheatequation_torch.utils.decompose import partition_coarse_grid

    points = np.asarray(points, np.float64)
    n, d = points.shape
    if ndevices < 2 or n == 0:
        return np.arange(n)
    xy = points[:, :2] if d >= 2 else np.stack([points[:, 0], np.zeros(n)], axis=1)
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    ij = np.minimum((coarse * (xy - lo) / span).astype(np.int64), coarse - 1)
    owner = partition_coarse_grid(coarse, coarse, ndevices)
    part = owner[ij[:, 0], ij[:, 1]]
    tile = ij[:, 0] * coarse + ij[:, 1]
    return np.lexsort((np.arange(n), tile, part))
