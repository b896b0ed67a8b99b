# coding=utf-8
"""VTK XML output: ``.vtu`` unstructured-grid snapshots + ``.pvd`` time
series — the interchange format every FEM post-processor (ParaView, VisIt,
meshio, pyvista) reads.

A copy of the JAX package's ``utils/vtu.py`` (numpy only).  The reference
exports only the OBJ surface (object.py:322-335) and has no volume or field
output: a ``.vtu`` carries the full TET/TRIANGLE volume mesh plus per-point
and per-cell fields (velocity, mass, von-Mises stress, det F, …), so a
user can slice, threshold and animate the interior — not just look at the
surface skin.

Format notes (self-contained writer: no vtk or meshio dependency):

* XML ``UnstructuredGrid`` with inline base64 ``format="binary"``
  DataArrays: each array's payload is ``base64(header || data)`` with a
  single ``header_type="UInt64"`` byte count — the uncompressed inline
  appended-free encoding every reader supports.
* Cell types: 5 = VTK_TRIANGLE (dim 2), 10 = VTK_TETRA (dim 3).
* 2D points are padded with z = 0 (VTK points are always 3-component).
* ``.pvd`` is the trivial ParaView collection index mapping
  ``timestep -> file``.
"""

from __future__ import annotations

import base64
import os
from typing import Mapping, Sequence, Tuple

import numpy as np

_VTK_TYPE = {
    np.dtype(np.float32): "Float32",
    np.dtype(np.float64): "Float64",
    np.dtype(np.int32): "Int32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _b64(a: np.ndarray) -> str:
    """Inline-binary payload: base64(UInt64 byte count || raw data)."""
    raw = np.ascontiguousarray(a).tobytes()
    header = np.uint64(len(raw)).tobytes()
    return base64.b64encode(header + raw).decode("ascii")


def _data_array(name: str | None, a: np.ndarray) -> str:
    a = np.asarray(a)
    if a.dtype == np.float16 or a.dtype == np.float64:
        a = a.astype(np.float64 if a.dtype == np.float64 else np.float32)
    if a.dtype not in _VTK_TYPE:
        a = a.astype(np.float32)
    ncomp = 1 if a.ndim == 1 else int(np.prod(a.shape[1:]))
    name_attr = f' Name="{name}"' if name else ""
    return (
        f'<DataArray type="{_VTK_TYPE[np.dtype(a.dtype)]}"{name_attr} '
        f'NumberOfComponents="{ncomp}" format="binary">'
        f"{_b64(a)}</DataArray>"
    )


def write_vtu(
    path: str,
    points: np.ndarray,  # (N, 2|3)
    cells: np.ndarray,  # (E, 3|4) triangle / tet connectivity
    point_data: Mapping[str, np.ndarray] | None = None,
    cell_data: Mapping[str, np.ndarray] | None = None,
) -> None:
    """Write one unstructured-grid snapshot.

    ``point_data`` values are (N,) scalars or (N, k) vectors; ``cell_data``
    values are (E,) or (E, k).  2D meshes are written as VTK_TRIANGLE
    cells with z = 0 points; 3D as VTK_TETRA."""
    points = np.asarray(points, np.float32)
    cells = np.asarray(cells, np.int64)
    n, d = points.shape
    e, nv = cells.shape
    if (d, nv) not in ((2, 3), (3, 4)):
        raise ValueError(
            f"unsupported mesh: {d}-D points with {nv}-vertex cells"
        )
    if d == 2:
        points = np.concatenate(
            [points, np.zeros((n, 1), np.float32)], axis=1
        )
    vtk_cell = np.uint8(5 if nv == 3 else 10)

    parts = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{n}" NumberOfCells="{e}">',
        "<Points>", _data_array(None, points), "</Points>",
        "<Cells>",
        _data_array("connectivity", cells.reshape(-1)),
        _data_array(
            "offsets", (np.arange(e, dtype=np.int64) + 1) * nv
        ),
        _data_array("types", np.full((e,), vtk_cell, np.uint8)),
        "</Cells>",
    ]
    for tag, data in (("PointData", point_data), ("CellData", cell_data)):
        if data:
            parts.append(f"<{tag}>")
            for name, arr in data.items():
                arr = np.asarray(arr)
                want = n if tag == "PointData" else e
                if arr.shape[0] != want:
                    raise ValueError(
                        f"{tag} array {name!r} has leading dim "
                        f"{arr.shape[0]}, expected {want}"
                    )
                parts.append(_data_array(name, arr))
            parts.append(f"</{tag}>")
    parts += ["</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    with open(path, "w") as f:
        f.write("\n".join(parts))


def write_pvd(path: str, entries: Sequence[Tuple[float, str]]) -> None:
    """ParaView collection index: ``entries`` is (timestep, vtu_path);
    paths are stored relative to the .pvd's directory when possible."""
    base = os.path.dirname(os.path.abspath(path))
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="Collection" version="1.0" '
        'byte_order="LittleEndian">',
        "<Collection>",
    ]
    for t, fname in entries:
        rel = os.path.relpath(os.path.abspath(fname), base)
        lines.append(
            f'<DataSet timestep="{t:.9g}" part="0" file="{rel}"/>'
        )
    lines += ["</Collection>", "</VTKFile>"]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def read_vtu(path: str):
    """Minimal reader for round-trip tests (inline-binary uncompressed
    VTU as produced by :func:`write_vtu`): returns
    ``(points, cells, point_data, cell_data)``."""
    import xml.etree.ElementTree as ET

    inv_type = {v: k for k, v in _VTK_TYPE.items()}

    def decode(el):
        raw = base64.b64decode(el.text.strip())
        nbytes = int(np.frombuffer(raw[:8], np.uint64)[0])
        a = np.frombuffer(
            raw[8:8 + nbytes], inv_type[el.attrib["type"]]
        )
        ncomp = int(el.attrib.get("NumberOfComponents", "1"))
        return a.reshape(-1, ncomp) if ncomp > 1 else a

    root = ET.parse(path).getroot()
    piece = root.find("UnstructuredGrid/Piece")
    points = decode(piece.find("Points/DataArray"))
    cells_el = {
        el.attrib["Name"]: el for el in piece.findall("Cells/DataArray")
    }
    conn = decode(cells_el["connectivity"])
    offs = decode(cells_el["offsets"])
    nv = int(offs[0])
    cells = conn.reshape(-1, nv)
    pd, cd = {}, {}
    for tag, out in (("PointData", pd), ("CellData", cd)):
        sec = piece.find(tag)
        if sec is not None:
            for el in sec.findall("DataArray"):
                out[el.attrib["Name"]] = decode(el)
    return points, cells, pd, cd
