"""Minimal GMSH ``.msh`` reader/writer — no GMSH dependency; the port's own
copy of ``nonlocalheatequation_tpu/utils/gmsh.py`` (NumPy only, so the
port reads the same arrays without importing the JAX package).

The reference's decomposition tool links the GMSH 4.7 C++ API just to pull
node coordinates and quad connectivity out of a ``.msh`` file
(src/domain_decomposition.cpp:68-80).  This module reads the same information
directly from the two ASCII format generations in the wild (4.1, the format
of the reference's data/*.msh fixtures, and legacy 2.2), and can generate
structured rectangle meshes so the toolchain is self-contained.

Only what the decomposition pipeline needs is parsed: node tag -> (x, y, z)
and 4-node quadrangle connectivity (GMSH element type 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

QUAD_TYPE = 3  # 4-node quadrangle (GMSH element type id)


@dataclass
class MshData:
    """Node coordinates and quad connectivity of one .msh file.

    ``coords[i]`` is the (x, y, z) of node tag ``node_tags[i]``; ``quads``
    holds 4 node *tags* per row (GMSH tags are 1-based and may be sparse).
    """

    node_tags: np.ndarray  # (n,) int64
    coords: np.ndarray  # (n, 3) float64
    quads: np.ndarray  # (m, 4) int64 node tags

    def quad_coords(self) -> np.ndarray:
        """(m, 4, 3) coordinates of each quad's corners."""
        order = np.argsort(self.node_tags, kind="stable")
        pos = np.searchsorted(self.node_tags, self.quads.ravel(), sorter=order)
        if (pos >= len(order)).any():
            raise ValueError("quad connectivity references unknown node tags")
        flat = order[pos]
        if not np.array_equal(self.node_tags[flat], self.quads.ravel()):
            raise ValueError("quad connectivity references unknown node tags")
        return self.coords[flat].reshape(-1, 4, 3)


def _sections(text: str) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            while j < len(lines) and lines[j].strip() != f"$End{name}":
                j += 1
            out[name] = [l.strip() for l in lines[i + 1 : j] if l.strip()]
            i = j + 1
        else:
            i += 1
    return out


def _parse_nodes_41(body: list[str]):
    # numEntityBlocks numNodes minTag maxTag; then per block:
    #   dim entityTag parametric numNodesInBlock; tags...; xyz...
    nblocks = int(body[0].split()[0])
    tags, coords = [], []
    pos = 1
    for _ in range(nblocks):
        n = int(body[pos].split()[3])
        pos += 1
        tags.extend(int(body[pos + i]) for i in range(n))
        pos += n
        for i in range(n):
            coords.append([float(v) for v in body[pos + i].split()[:3]])
        pos += n
    return np.asarray(tags, np.int64), np.asarray(coords, np.float64)


def _parse_elements_41(body: list[str]) -> np.ndarray:
    nblocks = int(body[0].split()[0])
    quads = []
    pos = 1
    for _ in range(nblocks):
        _dim, _etag, etype, n = (int(v) for v in body[pos].split())
        pos += 1
        if etype == QUAD_TYPE:
            for i in range(n):
                quads.append([int(v) for v in body[pos + i].split()[1:5]])
        pos += n
    return np.asarray(quads, np.int64).reshape(-1, 4)


def _parse_nodes_22(body: list[str]):
    n = int(body[0])
    tags = np.empty(n, np.int64)
    coords = np.empty((n, 3), np.float64)
    for i in range(n):
        parts = body[1 + i].split()
        tags[i] = int(parts[0])
        coords[i] = [float(v) for v in parts[1:4]]
    return tags, coords


def _parse_elements_22(body: list[str]) -> np.ndarray:
    n = int(body[0])
    quads = []
    for i in range(n):
        parts = [int(v) for v in body[1 + i].split()]
        etype, ntags = parts[1], parts[2]
        if etype == QUAD_TYPE:
            quads.append(parts[3 + ntags : 7 + ntags])
    return np.asarray(quads, np.int64).reshape(-1, 4)


# nodes per GMSH element type, for skipping non-quad blocks in binary files
_NODES_PER_TYPE = {1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6,
                   10: 9, 11: 10, 12: 27, 13: 18, 14: 14, 15: 1, 16: 8,
                   17: 20, 18: 15, 19: 13}


class _BinCursor:
    """Sequential reader over the binary body of a 4.1 .msh file."""

    def __init__(self, raw: bytes, endian: str, path: str):
        self.raw, self.endian, self.path, self.pos = raw, endian, path, 0

    def seek_section(self, name: str) -> None:
        marker = f"${name}".encode()
        at = self.raw.find(marker, self.pos)
        if at < 0:
            raise ValueError(f"{self.path}: no ${name} section")
        nl = self.raw.index(b"\n", at)
        self.pos = nl + 1

    def take(self, dtype: str, n: int) -> np.ndarray:
        dt = np.dtype(self.endian + dtype)
        end = self.pos + dt.itemsize * n
        if end > len(self.raw):
            raise ValueError(f"{self.path}: truncated binary .msh")
        out = np.frombuffer(self.raw[self.pos:end], dt)
        self.pos = end
        return out


def _read_msh_binary_41(raw: bytes, path: str, dsize: int) -> MshData:
    """GMSH 4.1 binary: same sections as ASCII, counts as size_t (the
    data-size from the header — 8 on common builds, 4 on 32-bit GMSH),
    block headers as 3 ints (+ one size_t), coordinates as doubles.
    Endianness comes from the int 1 written right after the format line
    (the reference reads these via the GMSH API,
    domain_decomposition.cpp:68-80)."""
    if dsize not in (4, 8):
        raise ValueError(
            f"{path}: unsupported binary .msh data-size {dsize} "
            "(expected 4 or 8)")
    szt = f"u{dsize}"
    fmt_at = raw.index(b"$MeshFormat")
    line_end = raw.index(b"\n", fmt_at + 12)
    one = raw[line_end + 1:line_end + 5]
    if len(one) < 4:
        raise ValueError(f"{path}: truncated binary .msh header")
    if int.from_bytes(one, "little") == 1:
        endian = "<"
    elif int.from_bytes(one, "big") == 1:
        endian = ">"
    else:
        raise ValueError(f"{path}: bad endianness probe in binary .msh")
    cur = _BinCursor(raw, endian, path)
    cur.pos = line_end + 5

    cur.seek_section("Nodes")
    nblocks, _nnodes, _mn, _mx = cur.take(szt, 4)
    tags, coords = [], []
    for _ in range(int(nblocks)):
        _dim, _etag, parametric = cur.take("i4", 3)
        if parametric:
            raise ValueError(f"{path}: parametric nodes not supported")
        n = int(cur.take(szt, 1)[0])
        tags.append(cur.take(szt, n).astype(np.int64))
        coords.append(cur.take("f8", 3 * n).reshape(n, 3))

    cur.seek_section("Elements")
    nblocks, _nelems, _mn, _mx = cur.take(szt, 4)
    quads = []
    for _ in range(int(nblocks)):
        _dim, _etag, etype = cur.take("i4", 3)
        n = int(cur.take(szt, 1)[0])
        if int(etype) not in _NODES_PER_TYPE:
            raise ValueError(
                f"{path}: unknown element type {int(etype)} in binary .msh")
        k = _NODES_PER_TYPE[int(etype)]
        block = cur.take(szt, n * (1 + k)).reshape(n, 1 + k)
        if int(etype) == QUAD_TYPE:
            quads.append(block[:, 1:5].astype(np.int64))
    return MshData(
        np.concatenate(tags) if tags else np.zeros(0, np.int64),
        np.concatenate(coords) if coords else np.zeros((0, 3)),
        np.concatenate(quads) if quads else np.zeros((0, 4), np.int64),
    )


def read_msh(path: str) -> MshData:
    """Parse a GMSH .msh file: ASCII 4.1 / 2.2, or binary 4.1."""
    with open(path, "rb") as f:
        raw = f.read()
    head = raw[:4096].decode("latin-1")
    if "$MeshFormat" not in head:
        raise ValueError(f"{path}: not a GMSH .msh file (no $MeshFormat)")
    fmt_line = head.split("$MeshFormat", 1)[1].lstrip().splitlines()[0]
    version, filetype = fmt_line.split()[:2]
    major = version.split(".")[0]
    if filetype == "1":
        if major != "4":
            raise ValueError(
                f"{path}: binary .msh only supported for format 4.x "
                f"(got {version}); re-export as 4.1 binary or ASCII")
        return _read_msh_binary_41(raw, path, int(fmt_line.split()[2]))
    sections = _sections(raw.decode("latin-1"))
    if major == "4":
        tags, coords = _parse_nodes_41(sections["Nodes"])
        quads = _parse_elements_41(sections["Elements"])
    elif major == "2":
        tags, coords = _parse_nodes_22(sections["Nodes"])
        quads = _parse_elements_22(sections["Elements"])
    else:
        raise ValueError(f"{path}: unsupported .msh version {version}")
    return MshData(tags, coords, quads)


def write_structured_msh(path: str, mx: int, my: int, dh: float,
                         x0: float = 0.0, y0: float = 0.0,
                         binary: bool = False) -> None:
    """Write an mx x my structured quad mesh as GMSH 4.1 (ASCII, or binary
    with ``binary=True`` — the variant the GMSH API also emits, which the
    reference accepts through its API linkage, domain_decomposition.cpp:68-70).

    Replaces running GMSH to mesh a rectangle: one surface entity, nodes on
    the (mx+1) x (my+1) lattice with spacing dh, row-major quads.  Readable
    by this module and by GMSH itself.
    """
    if binary:
        return _write_structured_msh_binary(path, mx, my, dh, x0, y0)
    nnx, nny = mx + 1, my + 1
    nnodes, nquads = nnx * nny, mx * my
    with open(path, "w") as f:
        f.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
        f.write("$Entities\n0 0 1 0\n1 "
                f"{x0:g} {y0:g} 0 {x0 + mx * dh:g} {y0 + my * dh:g} 0 0 0\n"
                "$EndEntities\n")
        f.write(f"$Nodes\n1 {nnodes} 1 {nnodes}\n2 1 0 {nnodes}\n")
        for t in range(1, nnodes + 1):
            f.write(f"{t}\n")
        for j in range(nny):
            for i in range(nnx):
                f.write(f"{x0 + i * dh:.17g} {y0 + j * dh:.17g} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n1 {nquads} 1 {nquads}\n2 1 {QUAD_TYPE} {nquads}\n")
        # corner order matches GMSH's output for a meshed rectangle (first two
        # nodes differ in y), which the reference's dh-inference recipe
        # depends on (domain_decomposition.cpp:99-104)
        tag = 1
        for j in range(my):
            for i in range(mx):
                n0 = j * nnx + i + 1
                f.write(f"{tag} {n0} {n0 + nnx} {n0 + nnx + 1} {n0 + 1}\n")
                tag += 1
        f.write("$EndElements\n")


def _write_structured_msh_binary(path: str, mx: int, my: int, dh: float,
                                 x0: float, y0: float) -> None:
    import struct

    nnx, nny = mx + 1, my + 1
    nnodes, nquads = nnx * nny, mx * my
    u8 = lambda *v: struct.pack(f"<{len(v)}Q", *v)  # noqa: E731
    i4 = lambda *v: struct.pack(f"<{len(v)}i", *v)  # noqa: E731
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n4.1 1 8\n")
        f.write(struct.pack("<i", 1))
        f.write(b"\n$EndMeshFormat\n")
        f.write(b"$Nodes\n")
        f.write(u8(1, nnodes, 1, nnodes))          # one block
        f.write(i4(2, 1, 0) + u8(nnodes))          # dim, etag, parametric, n
        f.write(np.arange(1, nnodes + 1, dtype="<u8").tobytes())
        xyz = np.zeros((nnodes, 3))
        jj, ii = np.divmod(np.arange(nnodes), nnx)
        xyz[:, 0] = x0 + ii * dh
        xyz[:, 1] = y0 + jj * dh
        f.write(xyz.astype("<f8").tobytes())
        f.write(b"\n$EndNodes\n")
        f.write(b"$Elements\n")
        f.write(u8(1, nquads, 1, nquads))
        f.write(i4(2, 1, QUAD_TYPE) + u8(nquads))
        rows = np.empty((nquads, 5), np.uint64)
        q = np.arange(nquads)
        j, i = np.divmod(q, mx)
        n0 = j * nnx + i + 1
        rows[:, 0] = q + 1
        rows[:, 1] = n0
        rows[:, 2] = n0 + nnx
        rows[:, 3] = n0 + nnx + 1
        rows[:, 4] = n0 + 1
        f.write(rows.astype("<u8").tobytes())
        f.write(b"\n$EndElements\n")


def write_point_cloud_msh(path: str, points: np.ndarray) -> None:
    """Write the nodes of a point cloud as a GMSH 2.2 ASCII file with no
    elements (tags 1..n, coordinates zero-padded to 3D, written with 17
    significant digits so they read back exactly).  A port-only helper:
    the unstructured CLI reads only the nodes."""
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] > 3:
        raise ValueError(f"points must be (N, d<=3), got {pts.shape}")
    xyz = np.zeros((len(pts), 3))
    xyz[:, :pts.shape[1]] = pts
    rows = np.column_stack([np.arange(1, len(pts) + 1), xyz])
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n{len(pts)}\n")
        np.savetxt(f, rows, fmt=["%d", "%.17g", "%.17g", "%.17g"])
        f.write("$EndNodes\n$Elements\n0\n$EndElements\n")
