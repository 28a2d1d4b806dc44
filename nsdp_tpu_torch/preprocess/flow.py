"""Correspondence-preserving surface / space flow sampling.

The port's own copy of ``nsdp_tpu/preprocess/flow.py``: host code
(numpy/scipy), the same bits as the JAX package's.

The core data trick of the reference pipeline (SURVEY.md §3.5): per identity
template, face indices, barycentric weights and normal-direction noise are
sampled ONCE from the canonical frame and replayed on every frame of every
sequence of that identity — so the i-th point of every
``surface_points.npz`` / ``flow.npz`` corresponds across all poses, and
supervision is plain pointwise L2.

Matches the reference writers (``generate_dataset_deform4d_surfaceflow.py``,
``generate_dataset_deform4d_spaceflow.py``): npz files carry float16
``points`` (+ ``normals`` for surface flow) plus the ``loc``/``scale`` of the
frame's normalisation; space flow adds uniform normal-direction noise in two
bands (sigma 0.1 for the first half, 0.02 for the second).
"""

import os
from typing import Dict, Optional

import numpy as np

from nsdp_tpu_torch.data.transforms import load_norm_params
from nsdp_tpu_torch.utils import meshio


def make_template_sample_info(
    template_mesh_path: str,
    surface_count: int = 100000,
    space_count: int = 200000,
    sigma1: float = 0.1,
    sigma2: float = 0.02,
    rng: Optional[np.random.RandomState] = None,
) -> Dict:
    """Draw the per-identity sampling info from the canonical-frame mesh."""
    rng = rng or np.random
    verts, faces = meshio.load_mesh(template_mesh_path)

    surf_face_idx, surf_alpha = meshio.sample_faces(
        verts, faces, surface_count, rng
    )
    space_face_idx, space_alpha = meshio.sample_faces(
        verts, faces, space_count, rng
    )
    half = space_count // 2
    noise = np.concatenate(
        [
            sigma1 * (2.0 * rng.rand(half, 1) - 1.0),
            sigma2 * (2.0 * rng.rand(space_count - half, 1) - 1.0),
        ],
        axis=0,
    )
    return {
        "surface": {"face_idx": surf_face_idx, "alpha": surf_alpha},
        "space": {"face_idx": space_face_idx, "alpha": space_alpha,
                  "noise": noise},
    }


def _normalized_frame(mesh_path: str, frame_dir: str):
    """Load a frame mesh and apply its own orig_to_gaps normalisation."""
    verts, faces = meshio.load_mesh(mesh_path)
    orig2world, _ = load_norm_params(
        os.path.join(frame_dir, "orig_to_gaps.txt")
    )
    s, t = orig2world[0, 0], orig2world[:3, 3]
    return (s * verts + t).astype(np.float64), faces, float(s), t


def write_surface_flow(
    mesh_path: str, frame_dir: str, sample_info: Dict, float16: bool = True
) -> str:
    """Write ``surface_points.npz`` for one frame."""
    verts, faces, s, t = _normalized_frame(mesh_path, frame_dir)
    info = sample_info["surface"]
    tri = verts[faces[info["face_idx"]]]
    points = (info["alpha"][:, :, None] * tri).sum(axis=1)
    normals = meshio.face_normals(verts, faces)[info["face_idx"]]

    dtype = np.float16 if float16 else np.float32
    out = os.path.join(frame_dir, "surface_points.npz")
    np.savez(
        out,
        points=points.astype(dtype),
        normals=normals.astype(dtype),
        loc=t.astype(dtype),
        scale=np.asarray(s, dtype=dtype),
    )
    return out


def write_space_flow(
    mesh_path: str, frame_dir: str, sample_info: Dict, float16: bool = True
) -> str:
    """Write ``flow.npz`` (near-surface space samples) for one frame."""
    verts, faces, s, t = _normalized_frame(mesh_path, frame_dir)
    info = sample_info["space"]
    tri = verts[faces[info["face_idx"]]]
    points = (info["alpha"][:, :, None] * tri).sum(axis=1)
    normals = meshio.face_normals(verts, faces)[info["face_idx"]]
    points = points + normals * info["noise"]

    dtype = np.float16 if float16 else np.float32
    out = os.path.join(frame_dir, "flow.npz")
    np.savez(
        out,
        points=points.astype(dtype),
        loc=t.astype(dtype),
        scale=np.asarray(s, dtype=dtype),
    )
    return out
