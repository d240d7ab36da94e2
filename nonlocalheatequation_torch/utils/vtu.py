"""Dependency-free VTK XML UnstructuredGrid (.vtu) writer — the port's own
copy of ``nonlocalheatequation_tpu/utils/vtu.py`` (NumPy only at import): the
snapshot writer :class:`VtuWriter` that the CSV/VTU logger uses
(utils/csvlog.py), the point-cloud writer of the unstructured CLI's
``--vtu``, and a reader for round trips.  For the same input and
compressor a file is byte for byte the JAX writer's.

Encoding: inline ``binary`` DataArrays — base64(UInt64 byte-count header ++
raw little-endian payload), header_type="UInt64"; with ``compress="zlib"``
the payload is zlib-deflated and the header becomes the VTK 4-word block
descriptor.  One VTK_VERTEX cell per node, so ParaView renders the points
without a glyph filter.
"""

from __future__ import annotations

import base64
import re
import struct
import zlib

import numpy as np

def writes_files() -> bool:
    """Whether this process writes the logs: always in one process, rank 0
    alone under a multi-process launch (parallel/multihost.py), as in the
    JAX package's CLIs."""
    from nonlocalheatequation_torch.parallel.multihost import process_index

    return process_index() == 0


_VTK_TYPES = {
    np.dtype(np.float64): "Float64",
    np.dtype(np.float32): "Float32",
    np.dtype(np.int32): "Int32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _b64_block(raw: bytes, compress: bool) -> str:
    if not compress:
        return base64.b64encode(struct.pack("<Q", len(raw)) + raw).decode()
    comp = zlib.compress(raw)
    # VTK compressed header: [#blocks, blocksize, last blocksize, compressed size]
    header = struct.pack("<4Q", 1, len(raw), len(raw), len(comp))
    return base64.b64encode(header).decode() + base64.b64encode(comp).decode()


def _data_array(name: str, arr: np.ndarray, ncomp: int, extra: str = "",
                compress: bool = False) -> str:
    payload = _b64_block(np.ascontiguousarray(arr).tobytes(), compress)
    comp_attr = f' NumberOfComponents="{ncomp}"' if ncomp else ""
    return (f'<DataArray type="{_VTK_TYPES[np.dtype(arr.dtype)]}" Name="{name}"{comp_attr}'
            f'{extra} format="binary">\n{payload}\n</DataArray>\n')


class VtuWriter:
    """Write one unstructured-grid snapshot (the reference's
    rw::writer::VtkWriter, include/writer.h:23-162):

        w = VtuWriter("out_vtk/simulate_0", compress_type="zlib")
        w.append_nodes(points)            # (N, 3) float array
        w.append_point_data("Temperature", u.ravel())
        w.add_time_step(t)
        w.close()
    """

    def __init__(self, filename: str, compress_type: str = ""):
        self.path = filename if filename.endswith(".vtu") else filename + ".vtu"
        self.compress = compress_type == "zlib"
        self.nodes = None
        self.point_data: list[tuple[str, np.ndarray]] = []
        self.cell_data: list[tuple[str, np.ndarray]] = []
        self.field_data: list[tuple[str, np.ndarray]] = []

    def append_nodes(self, nodes, displacement=None):
        """nodes: (N, 3) coordinates; an optional displacement is added."""
        pts = np.asarray(nodes, dtype=np.float64).reshape(-1, 3)
        if displacement is not None:
            pts = pts + np.asarray(displacement, dtype=np.float64).reshape(-1, 3)
        self.nodes = pts

    def append_point_data(self, name: str, data):
        """A per-node array of any numeric dtype, written as float64; (N, 3)
        input becomes a 3-component vector array."""
        arr = np.asarray(data)
        if arr.ndim == 2 and arr.shape[1] == 3:
            self.point_data.append((name, arr.astype(np.float64)))
        else:
            self.point_data.append((name, arr.astype(np.float64).ravel()))

    def append_cell_data(self, name: str, data):
        self.cell_data.append((name, np.asarray(data, dtype=np.float64).ravel()))

    def append_field_data(self, name: str, value: float):
        self.field_data.append((name, np.asarray([value], dtype=np.float64)))

    def add_time_step(self, timestep: float):
        """A TIME field (the callers pass simulation time, where the
        reference writes the wall clock)."""
        self.append_field_data("TIME", float(timestep))

    def close(self):
        """Write the file (rank 0 only under a multi-process launch: N racing
        writers to one path corrupt it)."""
        if not writes_files():
            return
        n = 0 if self.nodes is None else len(self.nodes)
        z = self.compress
        compressor = ' compressor="vtkZLibDataCompressor"' if z else ""
        parts = ['<?xml version="1.0"?>\n'
                 '<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian" '
                 f'header_type="UInt64"{compressor}>\n<UnstructuredGrid>\n'
                 f'<Piece NumberOfPoints="{n}" NumberOfCells="{n}">\n']
        if self.field_data:
            parts.append("<FieldData>\n")
            for name, arr in self.field_data:
                parts.append(_data_array(name, arr, 0, f' NumberOfTuples="{len(arr)}"', z))
            parts.append("</FieldData>\n")
        points = self.nodes if n else np.zeros((0, 3))
        parts.append("<Points>\n" + _data_array("Points", points, 3, compress=z)
                     + "</Points>\n<PointData>\n")
        for name, arr in self.point_data:
            parts.append(_data_array(name, arr, 3 if arr.ndim == 2 else 0, compress=z))
        parts.append("</PointData>\n<CellData>\n")
        for name, arr in self.cell_data:
            parts.append(_data_array(name, arr, 0, compress=z))
        parts.append("</CellData>\n<Cells>\n")
        parts.append(_data_array("connectivity", np.arange(n, dtype=np.int64), 0, compress=z))
        parts.append(_data_array("offsets", np.arange(1, n + 1, dtype=np.int64), 0, compress=z))
        parts.append(_data_array("types", np.full(n, 1, dtype=np.uint8), 0, compress=z))
        parts.append("</Cells>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
        with open(self.path, "w") as f:
            f.write("".join(parts))


def write_point_cloud_vtu(path: str, points: np.ndarray, point_data: dict | None = None,
                          time: float | None = None) -> None:
    """One-call .vtu point-cloud snapshot: (N, d<=3) coords (zero-padded to
    3D) plus named scalar arrays (any numeric dtype, written as float64), and
    a TIME field when ``time`` is given — the unstructured solver's output
    form."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] > 3:
        raise ValueError(f"points must be (N, d<=3), got {pts.shape}")
    if pts.shape[1] < 3:
        pts = np.pad(pts, ((0, 0), (0, 3 - pts.shape[1])))
    w = VtuWriter(path)
    w.append_nodes(pts)
    for name, data in (point_data or {}).items():
        w.append_point_data(name, data)
    if time is not None:
        w.add_time_step(time)
    w.close()


def read_vtu_point_data(path: str) -> dict[str, np.ndarray]:
    """Minimal reader for round-trip tests: ``{name: array}`` for the
    PointData arrays plus 'Points' and any FieldData entries, plain or
    zlib-compressed."""
    with open(path) as f:
        text = f.read()
    compress = "vtkZLibDataCompressor" in text
    out: dict[str, np.ndarray] = {}
    for m in re.finditer(
            r'<DataArray type="(\w+)" Name="([^"]+)"[^>]*format="binary">\s*([^<]+)\s*</DataArray>',
            text):
        vtk_type, name, payload = m.groups()
        dtype = {v: k for k, v in _VTK_TYPES.items()}[vtk_type]
        payload = payload.strip()
        if compress:
            # header: 4 x UInt64 (32 raw bytes = 44 base64 characters)
            header = struct.unpack("<4Q", base64.b64decode(payload[:44]))
            data = zlib.decompress(base64.b64decode(payload[44:]))[:header[1]]
        else:
            raw = base64.b64decode(payload)
            (nbytes,) = struct.unpack("<Q", raw[:8])
            data = raw[8:8 + nbytes]
        out[name] = np.frombuffer(data, dtype=dtype)
    return out
