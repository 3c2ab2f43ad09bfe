"""Minimal NumPy PLY reader for 3RScan label meshes (a copy of
``vlsat_tpu/data/ply.py``).

The reference loads every scan with trimesh on every __getitem__
(src/dataset/dataset_3dssg.py:42-58 via utils/util_ply.py:8-14) — the
dominant input cost.  This parser reads only what the pipeline needs
(vertex positions, the ``objectId``/``label`` instance attribute, optional
RGB/normals) directly into NumPy arrays, supports ascii and
binary_little_endian formats, and is wrapped by the optional C++ fast path
in ``vlsat_tpu_torch.native``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

INSTANCE_ATTRS = ("objectId", "label")  # reference util_ply.read_labels:8-14


@dataclass
class PlyVertexData:
    points: np.ndarray                      # (V, 3) float32
    instances: Optional[np.ndarray]         # (V,) int32 or None
    colors: Optional[np.ndarray] = None     # (V, 3) uint8
    normals: Optional[np.ndarray] = None    # (V, 3) float32
    faces: Optional[np.ndarray] = None      # (F, 3) int32 (when requested)


def read_ply_vertices(path: str, with_faces: bool = False) -> PlyVertexData:
    with open(path, "rb") as f:
        header_lines: List[str] = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
            if len(header_lines) > 1000:
                raise ValueError("malformed PLY header")

        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur_props: List[Tuple[str, str]] = []
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur_props = []
                elements.append((parts[1], int(parts[2]), cur_props))
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur_props.append((parts[-1], f"list:{parts[2]}:{parts[3]}"))
                else:
                    cur_props.append((parts[-1], _PLY_DTYPES[parts[1]]))

        if fmt not in ("ascii", "binary_little_endian"):
            raise NotImplementedError(f"PLY format {fmt}")

        vertex_el = next((e for e in elements if e[0] == "vertex"), None)
        if vertex_el is None:
            raise ValueError("no vertex element")
        _, count, props = vertex_el
        if any(d.startswith("list:") for _, d in props):
            raise NotImplementedError("list property in vertex element")
        dtype = np.dtype([(n, "<" + d) for n, d in props])

        faces = None
        if fmt == "binary_little_endian":
            if elements[0][0] != "vertex":
                raise NotImplementedError("vertex element must come first")
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
            if with_faces:
                faces = _read_faces_binary(f, elements)
        else:
            rows = []
            for _ in range(count):
                rows.append(tuple(f.readline().split()[: len(props)]))
            data = np.array(rows, dtype=dtype)
            if with_faces:
                faces = _read_faces_ascii(f, elements)

    return _vertex_data_from_rec(data, faces)


def _read_faces_binary(f, elements) -> Optional[np.ndarray]:
    """Parse a triangle face element that directly follows the vertices.

    PLY face rows are ``<count><count x index>``; meshes here are uniform
    triangle fans, so rows are fixed-size records — validated per row.
    """
    face_el = next((e for e in elements if e[0] == "face"), None)
    if face_el is None:
        return None
    _, count, props = face_el
    if count == 0:
        return np.zeros((0, 3), np.int32)
    if len(props) != 1 or not props[0][1].startswith("list:"):
        raise NotImplementedError("face element must be a single list property")
    _, cnt_t, idx_t = props[0][1].split(":")
    cnt_dt, idx_dt = np.dtype(_PLY_DTYPES[cnt_t]), np.dtype(_PLY_DTYPES[idx_t])
    row = np.dtype([("n", "<" + cnt_dt.str[1:]), ("v", "<" + idx_dt.str[1:], (3,))])
    raw = f.read(row.itemsize * count)
    rec = np.frombuffer(raw, dtype=row, count=count)
    if not (rec["n"] == 3).all():
        raise NotImplementedError("non-triangle face in PLY")
    return rec["v"].astype(np.int32)


def _read_faces_ascii(f, elements) -> Optional[np.ndarray]:
    face_el = next((e for e in elements if e[0] == "face"), None)
    if face_el is None:
        return None
    _, count, _ = face_el
    faces = np.zeros((count, 3), np.int32)
    for i in range(count):
        parts = f.readline().split()
        if int(parts[0]) != 3:
            raise NotImplementedError("non-triangle face in PLY")
        faces[i] = [int(parts[1]), int(parts[2]), int(parts[3])]
    return faces


def _vertex_data_from_rec(data: np.ndarray, faces: Optional[np.ndarray]) -> PlyVertexData:
    points = np.stack(
        [data["x"].astype(np.float32), data["y"].astype(np.float32), data["z"].astype(np.float32)],
        axis=-1,
    )
    instances = None
    for attr in INSTANCE_ATTRS:
        if attr in data.dtype.names:
            instances = data[attr].astype(np.int32)
            break
    colors = None
    if all(c in data.dtype.names for c in ("red", "green", "blue")):
        colors = np.stack([data["red"], data["green"], data["blue"]], axis=-1).astype(np.uint8)
    normals = None
    if all(c in data.dtype.names for c in ("nx", "ny", "nz")):
        normals = np.stack([data["nx"], data["ny"], data["nz"]], axis=-1).astype(np.float32)
    return PlyVertexData(points=points, instances=instances, colors=colors,
                         normals=normals, faces=faces)


def compute_vertex_normals(points: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Angle-weighted per-vertex normals from a triangle mesh.

    Replaces trimesh's computed ``vertex_normals`` that the reference
    dataset consumes when USE_NORMAL is on (dataset_3dssg.py:50-52) and
    matches its weighting (``trimesh.geometry.weighted_vertex_normals``):
    each face's UNIT normal accumulates onto its three vertices weighted by
    the corner angle the face subtends there, then the sums are normalized.
    Vertices not referenced by any face get a zero normal.
    """
    faces = np.asarray(faces, np.int64)
    p0, p1, p2 = (points[faces[:, k]].astype(np.float64) for k in range(3))
    fn = np.cross(p1 - p0, p2 - p0)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)

    def corner_angle(a, b, c):
        u, v = b - a, c - a
        cosang = (u * v).sum(-1) / np.maximum(
            np.linalg.norm(u, axis=-1) * np.linalg.norm(v, axis=-1), 1e-12)
        return np.arccos(np.clip(cosang, -1.0, 1.0))

    angles = [corner_angle(p0, p1, p2), corner_angle(p1, p2, p0),
              corner_angle(p2, p0, p1)]
    acc = np.zeros_like(points, dtype=np.float64)
    for k in range(3):
        np.add.at(acc, faces[:, k], fn * angles[k][:, None])
    norm = np.linalg.norm(acc, axis=-1, keepdims=True)
    return (acc / np.maximum(norm, 1e-12)).astype(np.float32)


def write_ply_vertices(path: str, points: np.ndarray,
                       instances: Optional[np.ndarray] = None,
                       colors: Optional[np.ndarray] = None,
                       normals: Optional[np.ndarray] = None,
                       faces: Optional[np.ndarray] = None) -> None:
    """Binary PLY writer (used by preprocessing tools and tests)."""
    n = len(points)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if instances is not None:
        props += [("objectId", "i4")]
    dtype = np.dtype([(name, "<" + d) for name, d in props])
    rec = np.empty(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    if instances is not None:
        rec["objectId"] = instances
    name_map = {"f4": "float", "u1": "uchar", "i4": "int"}
    with open(path, "wb") as f:
        head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        head += [f"property {name_map[d]} {name}" for name, d in props]
        if faces is not None:
            head += [f"element face {len(faces)}",
                     "property list uchar int vertex_indices"]
        head += ["end_header"]
        f.write(("\n".join(head) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None:
            frow = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
            frec = np.empty(len(faces), dtype=frow)
            frec["n"] = 3
            frec["v"] = np.asarray(faces, np.int32)
            f.write(frec.tobytes())
