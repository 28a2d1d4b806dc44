"""Visualisation helpers: error colormaps on meshes and point clouds, flow
fields and arrow meshes.

The port's own copy of ``nsdp_tpu/utils/visualize.py``, numpy only: the jet
colormap error-map mesh used by test-time mesh export (reference
``utils/visualize.py:36-79``, consumed at ``utils/generation.py:60-62``),
the PLY line-set flow field and the arrow meshes of volumetric and surface
flow (reference ``utils/visualize.py:201-312``), replacing the reference's
open3d calls.
"""

import numpy as np


def jet_colormap(values: np.ndarray, vmin: float = None, vmax: float = None):
    """Map scalars to RGB in [0,1] with a jet-style colormap."""
    values = np.asarray(values, dtype=np.float64)
    vmin = values.min() if vmin is None else vmin
    vmax = values.max() if vmax is None else vmax
    t = np.zeros_like(values) if vmax <= vmin else (values - vmin) / (vmax - vmin)
    t = np.clip(t, 0.0, 1.0)

    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def error_map_colors(errors: np.ndarray, error_max: float = 0.1) -> np.ndarray:
    """Per-vertex uint8 colors for an error field (clamped at ``error_max``)."""
    rgb = jet_colormap(np.clip(errors, 0.0, error_max), 0.0, error_max)
    return (rgb * 255).astype(np.uint8)


def vis_error_map(verts: np.ndarray, faces: np.ndarray, errors: np.ndarray):
    """(verts, faces, uint8 colors) triple for an error-colored mesh export."""
    return verts, faces, error_map_colors(errors)


def export_flow_field(
    path: str,
    points_src: np.ndarray,
    points_dst: np.ndarray,
    stride: int = 1,
) -> None:
    """Write a deformation flow field as a PLY line set (src -> dst edges).

    The standalone replacement for the reference's open3d arrow-field dumps
    (``utils/visualize.py:201-312`` there): every ``stride``-th point emits a
    line segment from its source to its deformed position, colored by
    displacement magnitude.
    """
    src = np.asarray(points_src)[::stride]
    dst = np.asarray(points_dst)[::stride]
    n = len(src)
    disp = np.linalg.norm(dst - src, axis=-1)
    colors = error_map_colors(disp, max(float(disp.max()), 1e-6))

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {2 * n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {n}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for i in range(n):
            c = colors[i]
            f.write(
                f"{src[i][0]} {src[i][1]} {src[i][2]} {c[0]} {c[1]} {c[2]}\n"
            )
            f.write(
                f"{dst[i][0]} {dst[i][1]} {dst[i][2]} {c[0]} {c[1]} {c[2]}\n"
            )
        for i in range(n):
            f.write(f"{2 * i} {2 * i + 1}\n")


# ---------------------------------------------------------------------------
# arrow-mesh flow visualisations (reference ``utils/visualize.py:201-312``)
# ---------------------------------------------------------------------------

def _unit_arrow(
    resolution: int = 10,
    cylinder_radius: float = 0.007,
    cone_radius: float = 0.014,
    cylinder_height: float = 0.08,
    cone_height: float = 0.04,
):
    """Canonical +z arrow (shaft + head) as (verts (V,3), faces (F,3)).

    Same proportions as the reference's
    ``o3d.geometry.TriangleMesh.create_arrow`` call — pure numpy, no open3d.
    """
    ang = np.linspace(0.0, 2 * np.pi, resolution, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=1)  # (R, 2)
    r = resolution

    verts = [
        np.concatenate([ring * cylinder_radius, np.zeros((r, 1))], 1),
        np.concatenate(
            [ring * cylinder_radius, np.full((r, 1), cylinder_height)], 1
        ),
        np.concatenate(
            [ring * cone_radius, np.full((r, 1), cylinder_height)], 1
        ),
        np.array([[0.0, 0.0, 0.0]]),
        np.array([[0.0, 0.0, cylinder_height + cone_height]]),
    ]
    verts = np.concatenate(verts).astype(np.float32)
    bottom_center, apex = 3 * r, 3 * r + 1

    faces = []
    nxt = np.roll(np.arange(r), -1)
    for i, j in zip(range(r), nxt):  # cylinder side
        faces += [[i, j, r + i], [j, r + j, r + i]]
    for i, j in zip(range(r), nxt):  # cone side + cone base ring
        faces += [[2 * r + i, 2 * r + j, apex]]
        faces += [[r + i, r + j, 2 * r + i], [r + j, 2 * r + j, 2 * r + i]]
    for i, j in zip(range(r), nxt):  # bottom cap
        faces += [[j, i, bottom_center]]
    return verts, np.asarray(faces, np.int32)


def _rotations_to(directions: np.ndarray) -> np.ndarray:
    """Batched rotation matrices taking +z to each (unit) direction
    (Rodrigues; antiparallel case handled by a 180° flip about x)."""
    d = np.asarray(directions, np.float64)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(np.broadcast_to(z, d.shape), d)  # axis * sin
    c = d[:, 2]  # cos
    s2 = (v ** 2).sum(-1)
    K = np.zeros((len(d), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -v[:, 2], v[:, 1]
    K[:, 1, 0], K[:, 1, 2] = v[:, 2], -v[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -v[:, 1], v[:, 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    coef = np.where(s2 > 1e-20, (1 - c) / np.maximum(s2, 1e-20), 0.0)
    R = eye + K + coef[:, None, None] * (K @ K)
    flip = np.diag([1.0, -1.0, -1.0])
    return np.where((c < -1 + 1e-9)[:, None, None], flip, R)


def _assemble_arrows(centers, flows, resolution=10):
    """One merged arrow mesh: (verts, faces, uint8 jet colors by |flow|)."""
    template_v, template_f = _unit_arrow(resolution)
    R = _rotations_to(flows)
    verts = np.einsum("nij,vj->nvi", R, template_v) + centers[:, None, :]
    n, V = verts.shape[:2]
    faces = template_f[None] + (np.arange(n) * V)[:, None, None]
    mag = np.linalg.norm(flows, axis=-1)
    vmax = max(float(mag.max()), 1e-12)
    vmin = float(mag.min())
    col = (jet_colormap(mag, vmin, vmax) * 255).astype(np.uint8)
    colors = np.repeat(col[:, None, :], V, axis=1)
    return (
        verts.reshape(-1, 3).astype(np.float32),
        faces.reshape(-1, 3).astype(np.int32),
        colors.reshape(-1, 3),
    )


def vis_flow_volume_arrow(flow_volume, flow_mask, dim=32, bbox_size=1.5,
                          resolution=10):
    """Arrow mesh for a volumetric flow grid (reference
    ``vis_flow_volume_arrow``, ``utils/visualize.py:201-257``): one arrow
    per masked cell at the cell centre, oriented along the flow, jet-colored
    by magnitude.  Returns (verts, faces, uint8 colors) for
    ``meshio.save_mesh``.

    ``flow_volume`` (N,3) / ``flow_mask`` (N,) are flat [H,W,D] grids with
    the reference's index layout (z slowest, x fastest).
    """
    flow_volume = np.asarray(flow_volume, np.float64)
    mask = np.asarray(flow_mask).astype(bool)
    idx = np.nonzero(mask)[0]
    z = idx // (dim * dim)
    y = (idx // dim) % dim
    x = idx % dim
    centers = np.stack(
        [((c + 0.5) / dim - 0.5) * bbox_size for c in (x, y, z)], axis=1
    )
    return _assemble_arrows(centers, flow_volume[idx] + 1e-6, resolution)


def vis_flow_surface_arrow(geometry, flow, mask, resolution=10):
    """Arrow mesh for per-point surface flow (reference
    ``vis_flow_surface_arrow``, ``utils/visualize.py:259-312``)."""
    geometry = np.asarray(geometry, np.float64)
    flow = np.asarray(flow, np.float64)
    sel = np.asarray(mask).astype(bool).reshape(len(geometry), -1)[:, 0]
    return _assemble_arrows(geometry[sel], flow[sel] + 1e-6, resolution)
