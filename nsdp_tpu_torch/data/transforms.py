"""Host-side numpy transforms of the data pipeline.

The port's own copy of ``nsdp_tpu/data/transforms.py``.  Functional equivalents of the reference's ``dataset/utils.py:8-147``: npz
loading, coordinate fixes, shared-permutation subsampling, bbox-rule handle
masks, source noise, KD-tree partial-shape holes, and the user-defined handle
synthesis used by interactive editing.
"""

import os
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import KDTree

from nsdp_tpu_torch.utils import meshio


# ---------------------------------------------------------------------------
# File loading
# ---------------------------------------------------------------------------

def load_npz_surface_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = np.load(path)
    return data["points"].astype(np.float32), data["normals"].astype(np.float32)


def load_npz_space_flow(path: str) -> np.ndarray:
    return np.load(path)["points"].astype(np.float32)


def load_mesh_info(path: str):
    """(verts f32, bidirectional edges i64, faces i64) — reference contract."""
    verts, faces = meshio.load_mesh(path)
    edges = meshio.edges_bidirectional(faces)
    return verts.astype(np.float32), edges, faces.astype(np.int64)


def load_norm_params(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load the 4x4 ``orig_to_gaps.txt`` normalisation matrix + inverse."""
    orig2world = np.reshape(np.loadtxt(path), [4, 4]).astype(np.float32)
    world2orig = np.linalg.inv(orig2world).astype(np.float32)
    return orig2world, world2orig


def fix_coord_system(points: np.ndarray) -> np.ndarray:
    """(x, y, z) -> (x, -z, y), the DeformationTransfer axis convention."""
    return np.ascontiguousarray(
        np.stack([points[:, 0], -points[:, 2], points[:, 1]], axis=1)
    )


def normalize_origin_mesh(vertices: np.ndarray, orig2world: np.ndarray):
    return (orig2world[:3, :3] @ vertices.T + orig2world[:3, 3:4]).T


# ---------------------------------------------------------------------------
# Sampling / masking transforms
# ---------------------------------------------------------------------------

def subsample_shared(
    arrays,
    num_samples: int,
    idxs: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
):
    """Subsample several aligned arrays with one shared permutation.

    The shared permutation preserves the cross-pose point correspondence the
    offline pipeline baked in (SURVEY.md §3.5 "correspondence invariant").
    """
    rng = rng or np.random
    n = arrays[0].shape[0]
    if idxs is None:
        if isinstance(rng, np.random.Generator) and num_samples < n:
            # O(num_samples) Floyd-style sampling — the O(n) legacy
            # permutation was the warm-cache assembly hot spot at
            # stage-1 scale (n=100k/200k per frame).  choice(shuffle=False)
            # returns near-sorted indices while the legacy permutation path
            # is uniformly ordered; row 0 seeds FPS downstream, so an O(k)
            # shuffle of the chosen k restores the reference's uniform
            # ordering statistics at negligible cost.
            idxs = rng.choice(n, num_samples, replace=False, shuffle=False)
            rng.shuffle(idxs)
        else:
            # num_samples >= n keeps the lenient legacy semantics:
            # all n rows, randomly ordered (Generator.choice would raise)
            idxs = rng.permutation(n)[:num_samples]
    return [a[idxs] for a in arrays], idxs


def maybe_subsample(arrays, num_samples, rng=None):
    """Subsample only when there are more points than requested (space flow)."""
    if arrays[0].shape[0] > num_samples:
        out, _ = subsample_shared(arrays, num_samples, rng=rng)
        return out
    return list(arrays)


def handle_mask_bbox(
    points_cano: np.ndarray,
    bbox_min: np.ndarray,
    bbox_max: np.ndarray,
    partial_range: float,
) -> np.ndarray:
    """Canonical-pose handle mask: head / tail / feet slabs of the bbox.

    y < min+r (head), y > max-r (tail), z < min+r (feet) — the quadruped
    convention of the reference (``dataset/utils.py:56-70``).
    """
    head = points_cano[:, 1] < bbox_min[1] + partial_range
    tail = points_cano[:, 1] > bbox_max[1] - partial_range
    feet = points_cano[:, 2] < bbox_min[2] + partial_range
    return head | tail | feet


def add_noise(points: np.ndarray, noise_level: float, rng=None) -> np.ndarray:
    rng = rng or np.random
    # standard_normal: present on both RandomState and Generator (randn is
    # RandomState-only)
    noise = rng.standard_normal(points.shape).astype(np.float32)
    return points + noise_level * noise


def partial_shape_indices(
    points: np.ndarray,
    handle_mask: np.ndarray,
    partial_shape_ratio: float,
    num_seeds: int = 5,
    rng=None,
) -> np.ndarray:
    """Indices that survive hole-cutting on non-handle regions.

    ``num_seeds`` KD-tree holes are cut around random non-handle seeds
    (reference ``dataset/utils.py:79-101``).
    """
    n = len(points)
    if partial_shape_ratio >= 1.0:
        return np.arange(n)
    rng = rng or np.random
    hole_ratio = 1.0 - partial_shape_ratio
    per_hole = int(hole_ratio * n // num_seeds)
    non_handle = points[~handle_mask]
    seed_sel = rng.permutation(len(non_handle))[:num_seeds]
    seeds = non_handle[seed_sel]
    tree = KDTree(points)
    _, remove = tree.query(seeds, k=per_hole)
    keep = set(range(n)) - set(np.asarray(remove).reshape(-1).tolist())
    return np.array(sorted(keep))


def compact_pad(keep: np.ndarray, n: int):
    """Row compactor for static-shape partial point clouds.

    Returns a function that moves ``keep``'s rows of an (n, ...) array to
    the front and zero-fills the rest — padded coordinate rows land on the
    origin, which FPS never selects (reference CUDA kernel's
    ``||p||^2 <= 1e-3`` skip); downstream masking is the caller's contract
    (see ``surface_valid_mask``).
    """

    def pad(a: np.ndarray) -> np.ndarray:
        out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
        out[: len(keep)] = a[keep]
        return out

    return pad


def min_valid_points(cfg: Dict) -> int:
    """Fewest surviving points the encoder can run on with a validity mask.

    The masked kNN/FPS paths require at least as many selectable points as
    the largest neighbourhood / downsample target at full resolution (a
    masked selection of k neighbours needs at least k selectable points).
    """
    ek = cfg.get("model", {}).get("encoder_kwargs", {})
    npl = ek.get("npoints_per_layer") or []
    first_down = npl[1] if len(npl) > 1 else 1
    return max(
        first_down, ek.get("nneighbor", 1), ek.get("nneighbor_reduced", 1), 1
    )


def pad_partial_static(keep: np.ndarray, arrays: Dict, min_valid: int = 1):
    """Compact ``keep``'s rows to the front of every array and zero-pad.

    Returns ``(padded dict, (n,) float32 validity mask)``.  Raises when
    fewer than ``min_valid`` rows survived hole-cutting — silently padding
    below the encoder's neighbourhood/downsample sizes would let masked
    (origin) points into neighbourhoods and corrupt results.
    """
    n = len(next(iter(arrays.values())))
    if len(keep) < min_valid:
        raise ValueError(
            f"partial shape kept only {len(keep)} of {n} points, below the "
            f"encoder's minimum of {min_valid} (largest neighbourhood / "
            "first downsample target); raise data.partial_shape_ratio or "
            "shrink the model's npoints_per_layer/nneighbor"
        )
    pad = compact_pad(keep, n)
    valid = np.zeros((n,), np.float32)
    valid[: len(keep)] = 1.0
    return {k: pad(v) for k, v in arrays.items()}, valid


def user_defined_handles(
    userhandle_cfg: Dict,
    verts_cano: np.ndarray,
    bbox_min: np.ndarray,
    bbox_max: np.ndarray,
    verts_src: np.ndarray,
    partial_range: float,
):
    """Interactive-editing target synthesis.

    Selects one of the named handle regions (head / tail / one of four feet,
    via bbox-slab rules on the canonical pose) and rigidly translates it by
    the configured (xtrans, ytrans, ztrans), producing the synthetic target.
    Returns (full handle mask, synthesised target verts) — reference
    ``dataset/utils.py:109-147``.
    """
    r = partial_range
    head = verts_cano[:, 1] < bbox_min[1] + r
    if userhandle_cfg.get("cliptail", False):
        tail = (verts_cano[:, 1] > bbox_max[1] - r) & (verts_cano[:, 2] > -r)
    else:
        tail = verts_cano[:, 1] > bbox_max[1] - r
    feet = verts_cano[:, 2] < bbox_min[2] + r
    handle_mask = head | tail | feet

    left = feet & (verts_cano[:, 0] > 0)
    right = feet & (verts_cano[:, 0] < 0)
    front = feet & (verts_cano[:, 1] < 0)
    behind = feet & (verts_cano[:, 1] > 0)

    region_masks = {
        "head": head,
        "tail": tail,
        "frontleftfoot": left & front,
        "frontrightfoot": right & front,
        "behindleftfoot": left & behind,
        "behindrightfoot": right & behind,
    }
    move_mask = None
    for name, mask in region_masks.items():
        if userhandle_cfg.get(name, False):
            move_mask = mask
            break
    if move_mask is None:
        raise ValueError("no user handle region enabled in config")

    trans = np.array(
        [
            userhandle_cfg.get("xtrans", 0.0),
            userhandle_cfg.get("ytrans", 0.0),
            userhandle_cfg.get("ztrans", 0.0),
        ],
        dtype=np.float32,
    )
    verts_tgt = verts_src + trans[None, :] * move_mask[:, None]
    return handle_mask, verts_tgt.astype(np.float32)
