"""Isosurface meshing API with the reference PyMarchingCubes surface.

The port's own copy of ``nsdp_tpu/meshing.py`` (its whole ``__all__``,
``:36-49``), host code computing the same bits: numpy/scipy around the
port's native marching tetrahedra (:mod:`nsdp_tpu_torch.native`, the same
C++ as the JAX package's).  No device work: meshing is an offline
preprocessing and visualisation step.

The reference vendors a Cython/C++ marching-cubes package
(reference ``external/PyMarchingCubes/marching_cubes/__init__.py:1-3``,
``_mcubes.pyx:23-66``) exposing plain / color / function-sampled /
super-sampled extraction plus binary-volume smoothing.  The extractor here
is marching *tetrahedra*, a different algorithm, chosen for its
branch-free tables and built-in vertex welding:

* meshes are topologically equivalent isosurfaces but not
  triangle-identical to the reference's;
* tetrahedra produce vertices on face/body diagonals as well as
  axis-aligned lattice edges; super-sampling refinement applies to the
  axis-aligned ones (the only ones the reference has at all).
"""

from typing import Callable, Tuple

import numpy as np

from nsdp_tpu_torch.native import marching_cubes as _mc_native
from nsdp_tpu_torch.utils.meshio import save_mesh

__all__ = [
    "marching_cubes",
    "marching_cubes_color",
    "marching_cubes_func",
    "marching_cubes_color_func",
    "marching_cubes_super_sampling",
    "smooth",
    "smooth_constrained",
    "smooth_gaussian",
    "signed_distance_function",
    "export_mesh",
    "export_obj",
    "export_off",
]


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def marching_cubes(volume: np.ndarray, isovalue: float):
    """Isosurface ``{volume == isovalue}`` as (verts (V,3), faces (F,3)).

    Vertices are in index coordinates, like the reference
    (``_mcubes.pyx:23-28``).
    """
    return _mc_native(np.asarray(volume, np.float32), float(isovalue))


def _trilinear(volume: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Vectorized trilinear interpolation of ``volume`` at index-space pts."""
    vol = np.asarray(volume, np.float64)
    shape = np.asarray(vol.shape[:3])
    p = np.clip(pts, 0.0, shape - 1.000001)
    i0 = np.floor(p).astype(np.int64)
    t = p - i0
    i1 = np.minimum(i0 + 1, shape - 1)
    out = 0.0
    for dx, wx in ((0, 1 - t[:, 0]), (1, t[:, 0])):
        for dy, wy in ((0, 1 - t[:, 1]), (1, t[:, 1])):
            for dz, wz in ((0, 1 - t[:, 2]), (1, t[:, 2])):
                idx = (
                    i1[:, 0] if dx else i0[:, 0],
                    i1[:, 1] if dy else i0[:, 1],
                    i1[:, 2] if dz else i0[:, 2],
                )
                w = wx * wy * wz
                out = out + vol[idx] * (w[:, None] if vol.ndim == 4 else w)
    return out


def marching_cubes_color(
    volume_sdf: np.ndarray, volume_color: np.ndarray, isovalue: float
):
    """Colored isosurface: verts (V,6) = [xyz, rgb], faces (F,3).

    ``volume_color`` is (nx, ny, nz, 3) like the reference
    (``pywrapper.cpp:217-256``); vertex colors are trilinearly interpolated
    at the vertex positions.
    """
    volume_color = np.asarray(volume_color)
    if volume_color.ndim != 4 or volume_color.shape[3] != 3:
        raise ValueError("volume_color must be (nx, ny, nz, 3)")
    if volume_color.shape[:3] != np.asarray(volume_sdf).shape:
        raise ValueError("SDF and RGB volumes do not match in size")
    verts, faces = marching_cubes(volume_sdf, isovalue)
    colors = _trilinear(volume_color, verts.astype(np.float64))
    return np.concatenate([verts, colors.astype(verts.dtype)], axis=1), faces


def _grid_eval(lower, upper, numx, numy, numz, f: Callable) -> np.ndarray:
    xs = np.linspace(lower[0], upper[0], numx)
    ys = np.linspace(lower[1], upper[1], numy)
    zs = np.linspace(lower[2], upper[2], numz)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    try:  # vectorized callables evaluate the whole grid at once
        vol = np.asarray(f(gx, gy, gz), np.float64)
        if vol.shape != gx.shape:
            raise ValueError
        return vol
    except Exception:  # scalar callables, like the reference accepts
        return np.vectorize(lambda x, y, z: float(f(x, y, z)))(gx, gy, gz)


def _check_func_args(lower, upper, numx, numy, numz):
    if any(l >= u for l, u in zip(lower, upper)):
        raise ValueError(
            "lower coordinates cannot be larger than upper coordinates"
        )
    if numx < 2 or numy < 2 or numz < 2:
        raise ValueError("numx, numy, numz cannot be smaller than 2")


def _index_to_world(verts, lower, upper, nums):
    scale = [(u - l) / (n - 1) for l, u, n in zip(lower, upper, nums)]
    return verts * np.asarray(scale, verts.dtype) + np.asarray(
        lower, verts.dtype
    )


def marching_cubes_func(
    lower: tuple, upper: tuple, numx: int, numy: int, numz: int,
    f: Callable, isovalue: float,
):
    """Isosurface of a function sampled on a [lower, upper] lattice
    (``_mcubes.pyx:36-46``).  ``f`` may be scalar ``f(x,y,z)->float`` (the
    reference's contract) or numpy-vectorized."""
    _check_func_args(lower, upper, numx, numy, numz)
    vol = _grid_eval(lower, upper, numx, numy, numz, f)
    verts, faces = marching_cubes(vol, isovalue)
    return _index_to_world(verts, lower, upper, (numx, numy, numz)), faces


def marching_cubes_color_func(
    lower: tuple, upper: tuple, numx: int, numy: int, numz: int,
    f_sdf: Callable, f_color_r: Callable, f_color_g: Callable,
    f_color_b: Callable, isovalue: float,
):
    """Colored function-sampled isosurface (``_mcubes.pyx:59-69``); vertex
    colors are evaluated exactly at the vertex positions."""
    _check_func_args(lower, upper, numx, numy, numz)
    vol = _grid_eval(lower, upper, numx, numy, numz, f_sdf)
    verts, faces = marching_cubes(vol, isovalue)
    world = _index_to_world(
        verts.astype(np.float64), lower, upper, (numx, numy, numz)
    )
    chans = []
    for fc in (f_color_r, f_color_g, f_color_b):
        try:
            c = np.asarray(fc(world[:, 0], world[:, 1], world[:, 2]),
                           np.float64)
            if c.shape != (len(world),):
                raise ValueError
        except Exception:
            c = np.asarray(
                [float(fc(*p)) for p in world], np.float64
            )
        chans.append(c)
    colors = np.stack(chans, axis=1)
    return (
        np.concatenate([world, colors], axis=1).astype(np.float32),
        faces,
    )


def marching_cubes_super_sampling(
    volumeX: np.ndarray, volumeY: np.ndarray, volumeZ: np.ndarray,
    isovalue: float,
):
    """Isosurface with per-axis super-sampled edge refinement.

    Each volume is densely sampled along ONE axis (``pywrapper.cpp:
    284-309``): volumeX has ``nx + (nx-1)*ssx`` samples along axis 0 at the
    coarse resolution of the other two axes, etc.  The base mesh is
    extracted on the coarse lattice; every vertex lying on an axis-aligned
    lattice edge is then relocated to the first fine-grid sign change along
    that edge — the same sharpening the reference performs during
    extraction.  (Vertices on tetrahedral face/body diagonals have no fine
    samples along their direction and keep the coarse interpolation.)
    """
    volumeX = np.asarray(volumeX, np.float64)
    volumeY = np.asarray(volumeY, np.float64)
    volumeZ = np.asarray(volumeZ, np.float64)
    nx, ny, nz = volumeY.shape[0], volumeX.shape[1], volumeX.shape[2]
    sss = []
    for vol, fine_axis, coarse_n in (
        (volumeX, 0, nx), (volumeY, 1, ny), (volumeZ, 2, nz)
    ):
        fine_n = vol.shape[fine_axis]
        if (fine_n - coarse_n) % (coarse_n - 1):
            raise ValueError(
                "supersampled arrays must have dim + ss*(dim-1) samples"
            )
        sss.append((fine_n - coarse_n) // (coarse_n - 1))
    if volumeX.shape[2] != volumeY.shape[2] or volumeX.shape[1] != volumeZ.shape[1] \
            or volumeY.shape[0] != volumeZ.shape[0]:
        raise ValueError("X,Y,Z supersampled sdf arrays must be compatible")

    coarse = volumeX[:: sss[0] + 1]
    verts, faces = marching_cubes(coarse, isovalue)
    verts = verts.astype(np.float64)

    fine_vols = (volumeX, volumeY, volumeZ)
    eps = 1e-5
    frac = verts - np.round(verts)
    on_axis = np.abs(frac) > eps  # fractional along that axis
    for axis in range(3):
        ss = sss[axis]
        if ss == 0:
            continue
        others = [a for a in range(3) if a != axis]
        sel = (
            on_axis[:, axis]
            & ~on_axis[:, others[0]]
            & ~on_axis[:, others[1]]
        )
        if not np.any(sel):
            continue
        v = verts[sel]
        i0 = np.floor(v[:, axis]).astype(np.int64)
        o0 = np.round(v[:, others[0]]).astype(np.int64)
        o1 = np.round(v[:, others[1]]).astype(np.int64)
        # fine samples along the edge: ss+2 values from node i0 to i0+1
        steps = np.arange(ss + 2)
        fine_idx = i0[:, None] * (ss + 1) + steps[None, :]
        coord = [None, None, None]
        coord[axis] = fine_idx
        coord[others[0]] = o0[:, None]
        coord[others[1]] = o1[:, None]
        line = fine_vols[axis][tuple(coord)] - isovalue  # (V, ss+2)
        sign_change = (line[:, :-1] * line[:, 1:]) <= 0
        has = sign_change.any(axis=1)
        j = np.argmax(sign_change, axis=1)
        a = line[np.arange(len(line)), j]
        b = line[np.arange(len(line)), j + 1]
        denom = np.where(np.abs(a - b) < 1e-30, 1.0, a - b)
        t = np.clip(a / denom, 0.0, 1.0)
        refined = i0 + (j + t) / (ss + 1)
        new_axis_coord = np.where(has, refined, v[:, axis])
        verts[np.where(sel)[0], axis] = new_axis_coord
    return verts.astype(np.float32), faces


# ---------------------------------------------------------------------------
# smoothing (reference marching_cubes/smoothing.py API)
# ---------------------------------------------------------------------------

def signed_distance_function(
    levelset: np.ndarray, band_radius: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(distance, border mask, band mask) of the 0.5 level set of a binary
    volume — positive inside, half-voxel offset at the boundary, matching
    the reference contract (``smoothing.py:194-217``)."""
    from scipy import ndimage as ndi

    binary = np.asarray(levelset) > 0
    dist = np.where(
        binary,
        ndi.distance_transform_edt(binary) - 0.5,
        -ndi.distance_transform_edt(~binary) + 0.5,
    )
    border = np.abs(dist) < 1
    band = np.abs(dist) <= band_radius
    return dist, border, band


def _second_difference_matrix(band: np.ndarray):
    """Sparse D stacking second differences along each axis over band
    voxels whose full 3-point stencil stays inside the band."""
    from scipy import sparse

    idx = np.full(band.shape, -1, np.int64)
    n = int(band.sum())
    idx[band] = np.arange(n)
    rows, cols, vals = [], [], []
    row = 0
    for axis in range(band.ndim):
        sl_m = [slice(1, -1)] * band.ndim
        sl_l = [slice(1, -1)] * band.ndim
        sl_r = [slice(1, -1)] * band.ndim
        sl_l[axis] = slice(0, -2)
        sl_m[axis] = slice(1, -1)
        sl_r[axis] = slice(2, None)
        im = idx[tuple(sl_m)]
        il = idx[tuple(sl_l)]
        ir = idx[tuple(sl_r)]
        ok = (im >= 0) & (il >= 0) & (ir >= 0)
        im, il, ir = im[ok], il[ok], ir[ok]
        r = np.arange(row, row + len(im))
        row += len(im)
        rows += [r, r, r]
        cols += [il, im, ir]
        vals += [
            np.ones(len(im)),
            -2.0 * np.ones(len(im)),
            np.ones(len(im)),
        ]
    D = sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(row, n),
    )
    return D.tocsr()


def smooth_constrained(
    binary_array: np.ndarray,
    band_radius: int = 4,
    max_iters: int = 250,
    rel_tol: float = 1e-6,
) -> np.ndarray:
    """Higher-order-smoothness surface extraction (Lempitsky, CVPR'10 — the
    method the reference implements, ``smoothing.py:220-270``): minimise the
    squared second differences of the signed distance over a narrow band by
    projected Jacobi, with per-voxel sign constraints so the zero level set
    stays within one voxel of the binary input."""
    dist, _, band = signed_distance_function(binary_array, band_radius)
    D = _second_difference_matrix(band)
    Q = (D.T @ D).tocsr()

    res = np.asarray(dist, np.float64)
    x = res[band]
    upper = np.where(x < 0, x, np.inf)
    lower = np.where(x > 0, x, -np.inf)
    upper[np.abs(upper) < 1] = 0
    lower[np.abs(lower) < 1] = 0

    diag = Q.diagonal()
    diag[diag == 0] = 1.0
    R = Q.copy()
    R.setdiag(0)
    R.eliminate_zeros()
    weight = 0.5
    check_each = 10
    cum_rel_tol = 1 - (1 - rel_tol) ** check_each
    energy = float(x @ (Q @ x)) / 2
    for i in range(max_iters):
        x_new = -(R @ x) / diag
        x = weight * x_new + (1 - weight) * x
        x = np.clip(x, lower, upper)
        if (i + 1) % check_each == 0:
            prev, energy = energy, float(x @ (Q @ x)) / 2
            if prev > 0 and (prev - energy) / prev < cum_rel_tol:
                break
    res[band] = x
    return res


def smooth_gaussian(binary_array: np.ndarray, sigma: float = 3) -> np.ndarray:
    from scipy import ndimage as ndi

    return ndi.gaussian_filter(
        np.asarray(binary_array, np.float64) - 0.5, sigma=sigma
    )


def smooth(binary_array: np.ndarray, method: str = "auto", **kwargs):
    """Smooth the 0.5 level set of a binary volume; the result's 0 isovalue
    is the smoothed surface (``smoothing.py:277-…``).  'constrained'
    preserves thin structures (slow, banded linear solve); 'gaussian' is
    fast but can destroy detail; 'auto' picks constrained below 512^3."""
    binary_array = np.asarray(binary_array)
    if method == "auto":
        method = (
            "constrained" if binary_array.size < 512 ** 3 else "gaussian"
        )
    if method == "constrained":
        return smooth_constrained(binary_array, **kwargs)
    if method == "gaussian":
        return smooth_gaussian(binary_array, **kwargs)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------------
# exporters (reference marching_cubes/exporter.py API)
# ---------------------------------------------------------------------------

def export_obj(vertices: np.ndarray, triangles: np.ndarray, filename: str):
    save_mesh(filename, np.asarray(vertices)[:, :3], triangles)


def export_off(vertices: np.ndarray, triangles: np.ndarray, filename: str):
    save_mesh(filename, np.asarray(vertices)[:, :3], triangles)


def export_mesh(vertices: np.ndarray, triangles: np.ndarray, filename: str):
    """Format from the file extension (obj/off/ply); (V,6) vertices keep
    their rgb in formats that support it."""
    vertices = np.asarray(vertices)
    colors = None
    if vertices.shape[1] >= 6 and filename.endswith(".ply"):
        colors = np.clip(vertices[:, 3:6] * 255.0, 0, 255).astype(np.uint8)
    save_mesh(filename, vertices[:, :3], triangles, vertex_colors=colors)
