"""DeformingThings4D ``.anime`` binary format.

The port's own copy of ``nsdp_tpu/preprocess/anime.py``: host code
(numpy/scipy), the same bits as the JAX package's.

Layout (reference ``preprocess/convert_deform4d_anime_to_mesh.py:51-75``):
int32 nf, nv, nt; float32 verts[nv*3] (frame 0); int32 faces[nt*3];
float32 offsets[(nf-1)*nv*3] (per-frame displacement from frame 0).
"""

import os
from typing import Tuple

import numpy as np

from nsdp_tpu_torch.utils import meshio


def anime_read(path: str) -> Tuple[int, int, int, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a .anime file -> (nf, nv, nt, verts0, faces, offsets)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=3)
        nf, nv, nt = (int(x) for x in header)
        verts = np.fromfile(f, dtype=np.float32, count=nv * 3).reshape(nv, 3)
        faces = np.fromfile(f, dtype=np.int32, count=nt * 3).reshape(nt, 3)
        offsets = np.fromfile(f, dtype=np.float32)
    if offsets.size != (nf - 1) * nv * 3:
        raise ValueError(f"inconsistent .anime data in {path}")
    offsets = offsets.reshape(nf - 1, nv, 3)
    return nf, nv, nt, verts, faces, offsets


def anime_write(path: str, verts0: np.ndarray, faces: np.ndarray,
                offsets: np.ndarray) -> None:
    """Write a .anime file (used by the synthetic fixtures and tests)."""
    nf = offsets.shape[0] + 1
    with open(path, "wb") as f:
        np.asarray([nf, len(verts0), len(faces)], dtype=np.int32).tofile(f)
        verts0.astype(np.float32).tofile(f)
        faces.astype(np.int32).tofile(f)
        offsets.astype(np.float32).tofile(f)


def convert_anime_to_meshes(anime_path: str, out_dir: str,
                            out_ext: str = "obj") -> int:
    """Export every animation frame as ``<out_dir>/<frame:04d>.<ext>``.

    Returns the number of frames written."""
    nf, nv, nt, verts, faces, offsets = anime_read(anime_path)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(nf):
        v = verts if i == 0 else verts + offsets[i - 1]
        meshio.save_mesh(os.path.join(out_dir, f"{i:04d}.{out_ext}"), v, faces)
    return nf
