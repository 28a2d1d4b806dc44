"""Mesh normalisation: the GAPS ``msh2msh`` replacement.

The port's own copy of ``nsdp_tpu/preprocess/normalize.py``: host code
(numpy/scipy), the same bits as the JAX package's.

The reference normalises every frame with the GAPS C++ binary
(``preprocess/others/process_mesh_local.sh:62-63``):

  msh2msh mesh model_normalized.obj -scale_by_pca -translate_by_centroid
          -scale 0.35 -debug_matrix orig_to_gaps.txt

The recorded ``orig_to_gaps.txt`` is a 4x4 *similarity* transform with a
uniform scale and a translation (consumers read ``scale = R[0,0]`` and
``loc = t``, reference ``generate_dataset_deform4d_surfaceflow.py:60-63`` —
no rotation), applied as ``x' = s*x + t``.

This implementation reproduces that contract in numpy: centroid to origin,
uniform scale ``target_scale / largest PCA standard deviation`` of the
vertices.  (GAPS is cloned at build time by the reference, not vendored, so
its exact PCA weighting cannot be byte-compared here; the normalisation
constant and the matrix layout are the load-bearing parts of the contract and
both are preserved.)
"""

import os
import shutil
from typing import Tuple

import numpy as np

from nsdp_tpu_torch.utils import meshio


def normalization_matrix(
    verts: np.ndarray, target_scale: float = 0.35
) -> np.ndarray:
    """4x4 orig->normalized similarity transform (x' = s*x + t)."""
    centroid = verts.mean(axis=0)
    centered = verts - centroid
    cov = centered.T @ centered / max(len(verts), 1)
    eigvals = np.linalg.eigvalsh(cov)
    std_max = float(np.sqrt(max(eigvals[-1], 1e-20)))
    s = target_scale / std_max
    mat = np.eye(4, dtype=np.float64)
    mat[0, 0] = mat[1, 1] = mat[2, 2] = s
    mat[:3, 3] = -s * centroid
    return mat


def normalize_mesh_file(
    mesh_path: str, out_dir: str, target_scale: float = 0.35,
    make_watertight: bool = False, watertight_spacing: float = 0.005,
    watertight_method: str = "sdf", watertight_depth: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Process one frame directory like ``process_mesh_local.sh``:

    copies the input to ``mesh_orig.<ext>``, writes the normalised mesh to
    ``model_normalized.obj`` and the transform to ``orig_to_gaps.txt``.
    With ``make_watertight`` the mesh is first remeshed to a closed
    manifold (``model_watertight.ply``) and the normalisation is computed
    from the watertight mesh, matching the shell's operand order.
    ``watertight_method`` picks between the two reference recipes:
    ``'sdf'`` is the GAPS msh2df SDF rasterisation
    (``process_mesh_local.sh:39-50``, ``make_watertight.sh:14-16``
    commented variant; ``watertight_spacing`` = msh2df ``-spacing``);
    ``'poisson'`` is the active ``meshlabserver -s screened_poisson.mlx``
    screened-Poisson reconstruction (``make_watertight.sh:19``;
    ``watertight_depth`` = the .mlx octree ``depth``).
    Returns (normalized verts, faces).
    """
    os.makedirs(out_dir, exist_ok=True)
    ext = os.path.splitext(mesh_path)[1]
    orig_copy = os.path.join(out_dir, "mesh_orig" + ext)
    if os.path.abspath(mesh_path) != os.path.abspath(orig_copy):
        shutil.copyfile(mesh_path, orig_copy)

    verts, faces = meshio.load_mesh(mesh_path)
    if make_watertight:
        if watertight_method == "poisson":
            from nsdp_tpu_torch.preprocess.poisson import watertight_mesh_poisson

            verts, faces = watertight_mesh_poisson(
                verts, faces, depth=watertight_depth
            )
        elif watertight_method == "sdf":
            from nsdp_tpu_torch.preprocess.watertight import watertight_mesh

            verts, faces = watertight_mesh(
                verts, faces, spacing=watertight_spacing
            )
        else:
            raise ValueError(
                f"unknown watertight_method {watertight_method!r}"
            )
        verts = verts.astype(np.float32)
        meshio.save_mesh(
            os.path.join(out_dir, "model_watertight.ply"), verts, faces
        )
    mat = normalization_matrix(verts, target_scale)
    s = mat[0, 0]
    t = mat[:3, 3]
    verts_norm = (s * verts + t).astype(np.float32)

    np.savetxt(os.path.join(out_dir, "orig_to_gaps.txt"), mat)
    meshio.save_mesh(
        os.path.join(out_dir, "model_normalized.obj"), verts_norm, faces
    )
    return verts_norm, faces


def normalize_mesh_directory(
    mesh_dir: str,
    dataset_dir: str,
    mesh_format: str = "obj",
    interval: int = 1,
    skip_existing: bool = True,
    target_scale: float = 0.35,
    make_watertight: bool = False,
    watertight_spacing: float = 0.005,
    watertight_method: str = "sdf",
    watertight_depth: int = 8,
) -> int:
    """Normalise every ``interval``-th frame of one sequence directory.

    Frame files are sorted and written to ``<dataset_dir>/<stem>/``; returns
    the number of frames processed.
    """
    frames = sorted(
        f for f in os.listdir(mesh_dir) if f.endswith("." + mesh_format)
    )
    frames = [frames[i] for i in range(len(frames)) if i % interval == 0]
    count = 0
    for fname in frames:
        stem = os.path.splitext(fname)[0]
        out_dir = os.path.join(dataset_dir, stem)
        marker = os.path.join(out_dir, "orig_to_gaps.txt")
        if skip_existing and os.path.isfile(marker):
            continue
        normalize_mesh_file(
            os.path.join(mesh_dir, fname), out_dir, target_scale,
            make_watertight=make_watertight,
            watertight_spacing=watertight_spacing,
            watertight_method=watertight_method,
            watertight_depth=watertight_depth,
        )
        count += 1
    return count
