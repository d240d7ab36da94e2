"""Dependency-free VTK XML UnstructuredGrid (.vtu) point-cloud writer; the
port's own copy of the part of ``nonlocalheatequation_tpu/utils/vtu.py``
that the unstructured CLI's ``--vtu`` uses (NumPy only).

Encoding: inline ``binary`` DataArrays — base64(UInt64 byte-count header ++
raw little-endian payload), header_type="UInt64", uncompressed, with one
VTK_VERTEX cell per node so ParaView renders the points without a glyph
filter.  Readable by ParaView/VTK and by :func:`read_vtu_point_data`.
"""

from __future__ import annotations

import base64
import re
import struct

import numpy as np

_VTK_TYPES = {
    np.dtype(np.float64): "Float64",
    np.dtype(np.float32): "Float32",
    np.dtype(np.int32): "Int32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _data_array(name: str, arr: np.ndarray, ncomp: int, extra: str = "") -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    payload = base64.b64encode(struct.pack("<Q", len(raw)) + raw).decode()
    comp_attr = f' NumberOfComponents="{ncomp}"' if ncomp else ""
    return (f'<DataArray type="{_VTK_TYPES[np.dtype(arr.dtype)]}" Name="{name}"{comp_attr}'
            f'{extra} format="binary">\n{payload}\n</DataArray>\n')


def write_point_cloud_vtu(path: str, points: np.ndarray, point_data: dict | None = None,
                          time: float | None = None) -> None:
    """One-call .vtu point-cloud snapshot: (N, d<=3) coords (zero-padded to
    3D) plus named scalar arrays (any numeric dtype, written as float64), and
    a TIME field when ``time`` is given — the unstructured solver's output
    form, byte for byte the JAX package's uncompressed file."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] > 3:
        raise ValueError(f"points must be (N, d<=3), got {pts.shape}")
    if pts.shape[1] < 3:
        pts = np.pad(pts, ((0, 0), (0, 3 - pts.shape[1])))
    path = path if path.endswith(".vtu") else path + ".vtu"
    n = len(pts)
    parts = ['<?xml version="1.0"?>\n'
             '<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian" '
             'header_type="UInt64">\n<UnstructuredGrid>\n'
             f'<Piece NumberOfPoints="{n}" NumberOfCells="{n}">\n']
    if time is not None:
        parts.append("<FieldData>\n" + _data_array(
            "TIME", np.asarray([float(time)]), 0, ' NumberOfTuples="1"') + "</FieldData>\n")
    parts.append("<Points>\n" + _data_array("Points", pts, 3) + "</Points>\n<PointData>\n")
    for name, data in (point_data or {}).items():
        parts.append(_data_array(name, np.asarray(data).astype(np.float64).ravel(), 0))
    parts.append("</PointData>\n<CellData>\n</CellData>\n<Cells>\n")
    parts.append(_data_array("connectivity", np.arange(n, dtype=np.int64), 0))
    parts.append(_data_array("offsets", np.arange(1, n + 1, dtype=np.int64), 0))
    parts.append(_data_array("types", np.full(n, 1, dtype=np.uint8), 0))
    parts.append("</Cells>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
    with open(path, "w") as f:
        f.write("".join(parts))


def read_vtu_point_data(path: str) -> dict[str, np.ndarray]:
    """Minimal reader for round-trip tests: ``{name: array}`` for the
    PointData arrays plus 'Points' and any FieldData entries of an
    uncompressed file."""
    text = open(path).read()
    out: dict[str, np.ndarray] = {}
    for m in re.finditer(
            r'<DataArray type="(\w+)" Name="([^"]+)"[^>]*format="binary">\s*([^<]+)\s*</DataArray>',
            text):
        vtk_type, name, payload = m.groups()
        dtype = {v: k for k, v in _VTK_TYPES.items()}[vtk_type]
        raw = base64.b64decode(payload.strip())
        (nbytes,) = struct.unpack("<Q", raw[:8])
        out[name] = np.frombuffer(raw[8:8 + nbytes], dtype=dtype)
    return out
