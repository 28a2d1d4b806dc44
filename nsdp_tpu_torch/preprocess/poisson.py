"""Screened Poisson surface reconstruction — the meshlab watertight path.

The port's own copy of ``nsdp_tpu/preprocess/poisson.py``: host code
(numpy/scipy), the same bits as the JAX package's.

The reference's *active* watertighting recipe is meshlabserver running a
screened-Poisson reconstruction filter
(``preprocess/others/make_watertight.sh:14-19`` +
``preprocess/others/screened_poisson.mlx:1-15``: octree depth 8,
pointWeight 4, scale 1.1); the GAPS ``msh2df`` variant it replaced is
commented out in the same script (ported as
:mod:`nsdp_tpu_torch.preprocess.watertight`).  This module supplies the Poisson
path without meshlab, selected by ``--watertight_method=poisson`` in the
preprocessing CLI.

Method (Kazhdan & Hoppe, "Screened Poisson Surface Reconstruction", ToG
2013, uniform-grid spectral variant): oriented surface samples are splatted
into a grid vector field V (the smoothed surface-normal field); the
indicator-like potential chi solves the screened Poisson equation

    (laplacian - screen) chi = div V

whose uniform-grid solution is a single FFT: both the second-order
Laplacian and the central-difference divergence are diagonal in the
Fourier basis, so ``chi_hat = div_hat / (lambda_k - screen)`` exactly
inverts the discrete operator.  The screening term makes the operator
negative-definite (no zero mode) and pins the far field to 0, standing in
for the octree method's point-interpolation screening (``pointWeight``).
The watertight mesh is the ``{chi = iso}`` isosurface with ``iso`` the
area-weighted mean of chi over the input samples (the standard Poisson
isovalue choice), extracted by the native marching-tetrahedra kernel —
closed by construction.

Grid conventions match :mod:`nsdp_tpu_torch.preprocess.watertight`: node-centred
grid, world = index * h + origin.  The FFT solve is periodic; the ``scale``
bounding-cube expansion (the .mlx's 1.1) plus the screening decay keep
wrap-around coupling negligible (validated by the closed-sphere test).
"""

from typing import Optional, Tuple

import numpy as np

from nsdp_tpu_torch.utils import meshio


def _splat_trilinear(points: np.ndarray, values: np.ndarray, dims, origin,
                     h: float) -> np.ndarray:
    """Accumulate per-point vector ``values`` onto grid nodes (trilinear)."""
    grid = np.zeros((3,) + tuple(dims), np.float64)
    u = (points - origin) / h
    i0 = np.floor(u).astype(np.int64)
    f = u - i0
    nx, ny, nz = dims
    for dx in (0, 1):
        wx = (1.0 - f[:, 0]) if dx == 0 else f[:, 0]
        ix = np.clip(i0[:, 0] + dx, 0, nx - 1)
        for dy in (0, 1):
            wy = (1.0 - f[:, 1]) if dy == 0 else f[:, 1]
            iy = np.clip(i0[:, 1] + dy, 0, ny - 1)
            for dz in (0, 1):
                wz = (1.0 - f[:, 2]) if dz == 0 else f[:, 2]
                iz = np.clip(i0[:, 2] + dz, 0, nz - 1)
                w = wx * wy * wz
                for c in range(3):
                    np.add.at(grid[c], (ix, iy, iz), w * values[:, c])
    return grid


def _sample_trilinear(grid: np.ndarray, points: np.ndarray, origin,
                      h: float) -> np.ndarray:
    """Trilinear interpolation of a scalar grid at world-space points."""
    dims = grid.shape
    u = (points - origin) / h
    i0 = np.clip(np.floor(u).astype(np.int64), 0,
                 np.asarray(dims) - 2)
    f = np.clip(u - i0, 0.0, 1.0)
    out = np.zeros(len(points), np.float64)
    for dx in (0, 1):
        wx = (1.0 - f[:, 0]) if dx == 0 else f[:, 0]
        for dy in (0, 1):
            wy = (1.0 - f[:, 1]) if dy == 0 else f[:, 1]
            for dz in (0, 1):
                wz = (1.0 - f[:, 2]) if dz == 0 else f[:, 2]
                out += (
                    wx * wy * wz
                    * grid[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
                )
    return out


def poisson_reconstruct(
    points: np.ndarray,
    normals: np.ndarray,
    depth: int = 8,
    scale: float = 1.1,
    point_weight: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reconstruct a closed mesh from oriented points.

    Args:
      points: (P, 3) surface samples.
      normals: (P, 3) outward-oriented unit normals.
      depth: grid resolution exponent (n = 2**depth nodes per axis; the
        .mlx's octree ``depth`` — 8 -> 256^3).
      scale: bounding-cube expansion factor (.mlx ``scale``).
      point_weight: screening strength (.mlx ``pointWeight``); scaled by
        the sample density so the default transfers across resolutions.

    Returns:
      (verts (V, 3) float64 world coords, faces (F, 3) int64).
    """
    from nsdp_tpu_torch.meshing import marching_cubes

    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    n = 1 << depth
    center = 0.5 * (points.min(axis=0) + points.max(axis=0))
    halfwidth = 0.5 * scale * float((points.max(0) - points.min(0)).max())
    h = 2.0 * halfwidth / (n - 1)
    origin = center - halfwidth
    dims = (n, n, n)

    # V: normal-splat vector field.  Per-sample weight 1/P keeps the field
    # scale density-independent; the final isovalue is relative to the
    # samples' own chi values, so the absolute scale cancels anyway.
    V = _splat_trilinear(points, normals / len(points), dims, origin, h)

    # spectral inversion of (laplacian - screen) chi = div V:
    # central-difference div -> i*sin(2*pi*k/n)/h per axis,
    # 5-point laplacian  -> (2*cos(2*pi*k/n) - 2)/h^2 per axis.
    k = np.fft.fftfreq(n) * 2.0 * np.pi  # = 2*pi*j/n
    kr = k[: n // 2 + 1]  # rfft last axis
    sin_x = np.sin(k)[:, None, None]
    sin_y = np.sin(k)[None, :, None]
    sin_z = np.sin(kr)[None, None, :]
    lam = (
        (2.0 * np.cos(k) - 2.0)[:, None, None]
        + (2.0 * np.cos(k) - 2.0)[None, :, None]
        + (2.0 * np.cos(kr) - 2.0)[None, None, :]
    ) / (h * h)
    # Screening strength.  The octree method screens at the sample
    # positions only, which cannot decay the interior plateau; a UNIFORM
    # screen does, with decay length L = 1/sqrt(screen).  Interior-fill
    # correctness therefore requires L to exceed the object size, so
    # pointWeight is normalised by the bounding-cube width:
    # screen = pw / (8 w^2)  ->  L = w * sqrt(8/pw) (~1.4 w at the .mlx
    # default pw=4) — far-field pinned within a couple of object sizes,
    # interior plateau intact (validated by the closed-sphere test's
    # inside-value assertion).  The k=0 mode needs no regularising at all:
    # the spectral divergence of a compact field is exactly 0 at k=0.
    width = 2.0 * halfwidth
    screen = point_weight / (8.0 * width * width)
    div_hat = (
        1j * sin_x / h * np.fft.rfftn(V[0])
        + 1j * sin_y / h * np.fft.rfftn(V[1])
        + 1j * sin_z / h * np.fft.rfftn(V[2])
    )
    chi = np.fft.irfftn(div_hat / (lam - screen), s=dims, axes=(0, 1, 2))

    # solving with outward normals gives chi ~ -indicator (negative
    # inside); the grid convention here (and in preprocess.watertight) is
    # positive outside, so chi already matches after the isovalue shift.
    iso = float(np.mean(_sample_trilinear(chi, points, origin, h)))
    verts, faces = marching_cubes(chi - iso, 0.0)
    return verts * h + origin, faces


def watertight_mesh_poisson(
    verts: np.ndarray,
    faces: np.ndarray,
    depth: int = 8,
    scale: float = 1.1,
    point_weight: float = 4.0,
    n_samples: int = 200_000,
    rng=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-manifold remesh of an arbitrary mesh via screened Poisson
    (the ``meshlabserver -s screened_poisson.mlx`` step)."""
    rng = rng or np.random
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    samples, fnormals = meshio.sample_oriented_points(
        verts, faces, n_samples, rng
    )
    return poisson_reconstruct(
        samples, fnormals, depth=depth, scale=scale,
        point_weight=point_weight,
    )
