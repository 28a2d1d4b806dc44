"""Standalone triangle-mesh IO and geometry helpers (numpy only).

The port's own copy of ``nsdp_tpu/utils/meshio.py``, unchanged.  The reference leans on trimesh/open3d for mesh loading, export, face normals
and surface sampling (reference ``dataset/utils.py:19-26``,
``utils/generation.py``, ``utils/eval_metric.py:46-56``).  Those libraries are
not dependencies here; this module provides the needed subset natively:

* OBJ / OFF / PLY (ascii + binary-little-endian) reading;
* OBJ / PLY export with optional per-vertex uint8 colors;
* face normals, bidirectional edge lists, area-weighted barycentric surface
  sampling (the basis of the correspondence-preserving dataset generation and
  of the Chamfer metric).
"""

import os
import struct
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load (verts float32 (V,3), faces int64 (F,3)) from obj/off/ply."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return _load_obj(path)
    if ext == ".off":
        return _load_off(path)
    if ext == ".ply":
        return _load_ply(path)
    raise ValueError(f"unsupported mesh format {ext!r}")


def _load_obj(path: str):
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:]]
                idx = [int(i) - 1 for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (
        np.asarray(verts, dtype=np.float32),
        np.asarray(faces, dtype=np.int64).reshape(-1, 3),
    )


def _load_off(path: str):
    with open(path, "r") as f:
        tokens = f.read().split()
    if tokens[0] != "OFF":
        raise ValueError("not an OFF file")
    nv, nf = int(tokens[1]), int(tokens[2])
    i = 4
    verts = np.asarray(tokens[i : i + 3 * nv], dtype=np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        cnt = int(tokens[i])
        poly = [int(t) for t in tokens[i + 1 : i + 1 + cnt]]
        for k in range(1, cnt - 1):
            faces.append([poly[0], poly[k], poly[k + 1]])
        i += 1 + cnt
    return verts, np.asarray(faces, dtype=np.int64).reshape(-1, 3)


_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _load_ply(path: str):
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_TYPES[parts[3]], True, _PLY_TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], False, None))

    verts, faces = None, []
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.asarray(
                    tokens[pos : pos + count * width], dtype=np.float64
                ).reshape(count, width)
                cols = [p[0] for p in props]
                verts = arr[:, [cols.index("x"), cols.index("y"), cols.index("z")]]
                pos += count * width
            elif name == "face":
                for _ in range(count):
                    cnt = int(tokens[pos]); pos += 1
                    poly = [int(t) for t in tokens[pos : pos + cnt]]; pos += cnt
                    for k in range(1, cnt - 1):
                        faces.append([poly[0], poly[k], poly[k + 1]])
            else:
                for _ in range(count):
                    pos += len(props)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and not any(p[2] for p in props):
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float64)
            elif name == "face":
                for _ in range(count):
                    cdt = np.dtype("<" + props[0][3])
                    cnt = int(np.frombuffer(body, cdt, 1, off)[0])
                    off += cdt.itemsize
                    idt = np.dtype("<" + props[0][1])
                    poly = np.frombuffer(body, idt, cnt, off).tolist()
                    off += idt.itemsize * cnt
                    for k in range(1, cnt - 1):
                        faces.append([poly[0], poly[k], poly[k + 1]])
            else:
                raise ValueError(f"unhandled ply element {name}")
    else:
        raise ValueError(f"unsupported ply format {fmt}")
    return (
        verts.astype(np.float32),
        np.asarray(faces, dtype=np.int64).reshape(-1, 3),
    )


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def save_mesh(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
) -> None:
    """Write a mesh to .obj or .ply (ascii), with optional uint8 colors."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        _save_obj(path, verts, faces, vertex_colors)
    elif ext == ".ply":
        _save_ply(path, verts, faces, vertex_colors)
    elif ext == ".off":
        _save_off(path, verts, faces)
    else:
        raise ValueError(f"unsupported export format {ext!r}")


def _save_off(path, verts, faces):
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(verts)} {len(faces)} 0\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def _save_obj(path, verts, faces, colors):
    with open(path, "w") as f:
        for i, v in enumerate(verts):
            if colors is not None:
                c = colors[i].astype(np.float64) / 255.0
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def _save_ply(path, verts, faces, colors):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            if colors is not None:
                c = colors[i]
                f.write(f"{v[0]} {v[1]} {v[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n")
            else:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def save_pointcloud(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
) -> None:
    """Write a point cloud to .ply (ascii), colors as uint8 or float in [0,1]."""
    if colors is not None and colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i, p in enumerate(points):
            if colors is not None:
                c = colors[i]
                f.write(f"{p[0]} {p[1]} {p[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n")
            else:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------

def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit face normals (F, 3); degenerate faces get zero normals."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-20)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (V, 3)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norm, 1e-20)


def face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)


def edges_bidirectional(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges emitted in both directions, (2E, 2) int64.

    Matches the reference's mesh loader contract
    (``dataset/utils.py:19-26``: trimesh ``edges`` + reversed copies).
    """
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    rev = e[:, ::-1]
    return np.concatenate([e, rev], axis=0).astype(np.int64)


def sample_faces(
    verts: np.ndarray,
    faces: np.ndarray,
    count: int,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted face indices + barycentric coords for surface sampling.

    Returns (face_idx (count,), bary (count, 3)).  ``points = (bary[:, :,
    None] * verts[faces[face_idx]]).sum(1)``.  The barycentric draw uses the
    sqrt trick for uniformity on each triangle.
    """
    rng = rng or np.random
    areas = face_areas(verts, faces)
    total = areas.sum()
    if total <= 0:
        probs = np.full(len(faces), 1.0 / len(faces))
    else:
        probs = areas / total
    face_idx = rng.choice(len(faces), size=count, p=probs)
    r1 = np.sqrt(rng.uniform(size=count))
    r2 = rng.uniform(size=count)
    bary = np.stack([1 - r1, r1 * (1 - r2), r1 * r2], axis=1)
    return face_idx, bary


def sample_oriented_points(
    verts: np.ndarray,
    faces: np.ndarray,
    count: int,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform surface samples with their face normals.

    Returns (points (count, 3), normals (count, 3)) — the oriented point
    set both watertighting backends (SDF rasterisation and screened
    Poisson) reconstruct from.
    """
    rng = rng or np.random
    face_idx, bary = sample_faces(verts, faces, count, rng)
    tris = verts[faces[face_idx]]
    points = (bary[:, :, None] * tris).sum(axis=1)
    normals = face_normals(verts, faces)[face_idx]
    return points, normals


def sample_surface(
    verts: np.ndarray,
    faces: np.ndarray,
    count: int,
    rng: Optional[np.random.RandomState] = None,
    return_index: bool = False,
):
    """Uniform area-weighted surface samples, trimesh-``sample`` equivalent."""
    face_idx, bary = sample_faces(verts, faces, count, rng)
    tri = verts[faces[face_idx]]  # (count, 3, 3)
    pts = (bary[:, :, None] * tri).sum(axis=1).astype(np.float32)
    if return_index:
        return pts, face_idx
    return pts
