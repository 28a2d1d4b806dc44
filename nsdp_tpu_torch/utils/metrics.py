"""Evaluation metrics: vertex L2, face-normal consistency, Chamfer-L1.

The port's own copy of ``nsdp_tpu/utils/metrics.py``, the same protocol as
the reference (``utils/eval_metric.py:6-61``):

* ``l2``  — mean squared vertex distance between prediction and ground truth;
* ``fnc`` — mean |dot| of unit face normals (orientation-agnostic);
* ``cd``  — Chamfer-L1 over 30k barycentric surface samples drawn
  area-weighted from the *predicted* mesh's faces, with the same face indices
  and Dirichlet(1,1,1) barycentric weights applied to both meshes, via exact
  nearest neighbours.

The nearest-neighbour search is the port's native float32 KD-tree
(:mod:`nsdp_tpu_torch.native`, the same C++ as ``nsdp_tpu.native``), as the
JAX package's ``_nn_dists`` prefers (``nsdp_tpu/utils/metrics.py:23-31``),
so ``l2``/``fnc``/``cd`` equal the JAX package's bit for bit.  scipy's
float64 KD-tree finds the same neighbours but not the same distances
(float64 against float32 rounding), so it is not used; a failed native
build raises.
"""

from typing import Dict

import numpy as np

from nsdp_tpu_torch.native import nearest_neighbor_distances
from nsdp_tpu_torch.utils import meshio


def _nn_dists(query: np.ndarray, points: np.ndarray) -> np.ndarray:
    return nearest_neighbor_distances(query, points)


def compute_dist_square(vertices: np.ndarray, vertices_gt: np.ndarray) -> float:
    return float(((vertices - vertices_gt) ** 2).sum(-1).mean())


def normal_consistency(normals_src: np.ndarray, normals_tgt: np.ndarray) -> float:
    a = normals_src / np.linalg.norm(normals_src, axis=-1, keepdims=True)
    b = normals_tgt / np.linalg.norm(normals_tgt, axis=-1, keepdims=True)
    return float(np.abs((a * b).sum(axis=-1)).mean())


def chamfer_distance(points: np.ndarray, points_gt: np.ndarray) -> float:
    completeness = _nn_dists(points, points_gt)
    accuracy = _nn_dists(points_gt, points)
    return float(0.5 * (accuracy.mean() + completeness.mean()))


def compute_evaluation_metrics(
    out_dict: Dict, pointcloud_size: int = 30000, rng=None
) -> Dict[str, float]:
    """Evaluate one test pair (batch dim squeezed), reference protocol."""
    rng = rng or np.random
    verts_pred = np.asarray(out_dict["verts_tgt_pred"]).squeeze()
    verts_gt = np.asarray(out_dict["verts_tgt"]).squeeze()
    faces = np.asarray(out_dict["faces"]).squeeze()

    eval_dict = {"l2": compute_dist_square(verts_pred, verts_gt)}

    fn_pred = meshio.face_normals(verts_pred, faces)
    fn_gt = meshio.face_normals(verts_gt, faces)
    eval_dict["fnc"] = normal_consistency(fn_pred, fn_gt)

    # shared face_idx (area-weighted on predicted mesh) + shared Dirichlet
    # barycentric weights for pred and gt surface samples
    face_idx, _ = meshio.sample_faces(verts_pred, faces, pointcloud_size, rng)
    alpha = rng.dirichlet((1.0,) * 3, pointcloud_size)
    tri_pred = verts_pred[faces[face_idx]]
    tri_gt = verts_gt[faces[face_idx]]
    pts_pred = (alpha[:, :, None] * tri_pred).sum(axis=1)
    pts_gt = (alpha[:, :, None] * tri_gt).sum(axis=1)
    eval_dict["cd"] = chamfer_distance(pts_pred, pts_gt)

    return eval_dict
