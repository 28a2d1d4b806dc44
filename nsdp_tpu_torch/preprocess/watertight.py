"""Watertight remeshing — the GAPS ``msh2df`` step, in Python.

The port's own copy of ``nsdp_tpu/preprocess/watertight.py``: host code
(numpy/scipy), the same bits as the JAX package's.

The reference's preprocessing optionally watertights each input mesh before
normalisation (``preprocess/others/process_mesh_local.sh:39-50``):

  msh2df mesh tmp.grd -output_mesh watertight.ply \\
      -estimate_sign -spacing 0.005 -estimate_sign_using_normals

i.e. rasterise the mesh into a signed distance grid (sign estimated from
surface normals), then extract the zero isosurface — any open/self-
intersecting input becomes a closed manifold.  The step ships disabled
upstream (``make_watertight=false`` at ``process_mesh_local.sh:22``) but is
part of the declared pipeline; this module provides it without the GAPS
binaries:

* dense area-weighted surface sampling with normals (``utils.meshio``),
* unsigned grid distance via KD-tree over the samples,
* sign from the nearest samples' normal orientation (majority over k,
  matching ``-estimate_sign_using_normals``' intent),
* zero isosurface via the native marching-tetrahedra extractor
  (``nsdp_tpu_torch.meshing``).

Host-side numpy/scipy, like the rest of preprocessing.
"""

from typing import Tuple

import numpy as np

from nsdp_tpu_torch.utils import meshio


def mesh_to_signed_distance_grid(
    verts: np.ndarray,
    faces: np.ndarray,
    spacing: float = 0.005,
    padding: float = None,
    n_samples: int = 200_000,
    sign_k: int = 5,
    rng=None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Signed distance field of a (possibly unclean) mesh.

    Returns (grid (nx,ny,nz), origin (3,), spacing): positive outside,
    negative inside, sign estimated from the ``sign_k`` nearest surface
    samples' normals plus a boundary flood fill (see below).  ``padding``
    defaults to 6 voxels — enough free space around the mesh for the
    flood fill to flow around normal-vote artifacts near open boundaries.
    """
    from scipy.spatial import cKDTree

    rng = rng or np.random
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)

    if padding is None:
        padding = 6.0 * spacing
    lo = verts.min(axis=0) - padding
    hi = verts.max(axis=0) + padding
    dims = np.maximum(np.ceil((hi - lo) / spacing).astype(int) + 1, 2)

    samples, fnormals = meshio.sample_oriented_points(
        verts, faces, n_samples, rng
    )

    xs = lo[0] + spacing * np.arange(dims[0])
    ys = lo[1] + spacing * np.arange(dims[1])
    zs = lo[2] + spacing * np.arange(dims[2])
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    queries = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    tree = cKDTree(samples)
    dist, idx = tree.query(queries, k=sign_k, workers=-1)
    if sign_k == 1:
        dist, idx = dist[:, None], idx[:, None]
    # outside iff (query - sample) . normal > 0, majority over k neighbours
    to_q = queries[:, None, :] - samples[idx]
    votes = np.sign(np.einsum("qkc,qkc->qk", to_q, fnormals[idx]))
    sign = np.where(votes.sum(axis=1) >= 0, 1.0, -1.0)

    # Flood-fill correction (GAPS ``-estimate_sign`` semantics): normal
    # votes are noisy near open boundaries — e.g. above a hole, the nearest
    # samples are rim points with near-tangential normals, and a wrongly
    # "inside" region can leak to the grid boundary, clipping the
    # isosurface open.  The outside region is grown from the grid boundary
    # through voxels that are far from the surface AND not unanimously
    # voted inside — unanimous-inside voxels (e.g. a shape's interior,
    # visible through a hole) block the fill, so the fill relabels exactly
    # the low-confidence leak regions without flooding through holes.
    from scipy import ndimage

    udist = dist[:, 0].reshape(tuple(dims))
    votes_sum = votes.sum(axis=1).reshape(tuple(dims))
    far = udist > 1.5 * spacing
    unanimous_inside = votes_sum <= -sign_k
    fill_region = far & ~unanimous_inside
    labels, n_lab = ndimage.label(fill_region)
    if n_lab:
        edge_labels = np.unique(
            np.concatenate([
                labels[0].ravel(), labels[-1].ravel(),
                labels[:, 0].ravel(), labels[:, -1].ravel(),
                labels[:, :, 0].ravel(), labels[:, :, -1].ravel(),
            ])
        )
        edge_labels = edge_labels[edge_labels > 0]
        outside_far = np.isin(labels, edge_labels) & fill_region
        inside_far = far & ~outside_far
        sign = sign.reshape(tuple(dims))
        sign[outside_far] = 1.0
        sign[inside_far] = -1.0
        sign = sign.reshape(-1)

    grid = (sign * dist[:, 0]).reshape(tuple(dims))
    return grid, lo, spacing


def watertight_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    spacing: float = 0.005,
    padding: float = None,
    n_samples: int = 200_000,
    rng=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-manifold remesh of an arbitrary input mesh (``msh2df
    -output_mesh`` equivalent): signed-distance rasterisation + zero
    isosurface."""
    from nsdp_tpu_torch.meshing import marching_cubes

    grid, origin, h = mesh_to_signed_distance_grid(
        verts, faces, spacing=spacing, padding=padding,
        n_samples=n_samples, rng=rng,
    )
    w_verts, w_faces = marching_cubes(grid, 0.0)
    return w_verts * h + origin, w_faces


def watertight_mesh_file(
    mesh_in: str,
    mesh_out: str,
    spacing: float = 0.005,
    n_samples: int = 200_000,
    rng=None,
) -> None:
    """File-level wrapper mirroring the shell step: read, remesh, write."""
    verts, faces = meshio.load_mesh(mesh_in)
    w_verts, w_faces = watertight_mesh(
        verts, faces, spacing=spacing, n_samples=n_samples, rng=rng
    )
    meshio.save_mesh(mesh_out, w_verts.astype(np.float32), w_faces)
