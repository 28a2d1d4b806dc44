"""Synthetic fixture generator: a fake dataset on the real directory
contract, for tests and end-to-end runs (the port's own copy of
``nsdp_tpu/data/synthetic.py``, plus a writer of the mesh-only user-handle
layout).

Writes ``<root>/<identity>_<motion>/<frame>/`` directories containing
``orig_to_gaps.txt``, ``surface_points.npz``, ``flow.npz`` and
``mesh_orig.obj``, plus split ``.lst`` files — everything
:class:`nsdp_tpu_torch.data.datasets.Deform4DFlowDataset` expects, generated
from a deforming icosphere (a smooth twist+bend parameterised by frame index).
The per-identity surface/space samples use fixed face indices + barycentric
coordinates replayed across frames, reproducing the correspondence invariant
of the offline pipeline (SURVEY.md §3.5).  The icosphere's size sets the
mesh's: subdivision 6 gives 40,962 vertices and 81,920 faces.
"""

import os
from typing import Sequence, Tuple

import numpy as np

from nsdp_tpu_torch.utils import meshio


def icosphere(subdivisions: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere mesh (verts, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts_list[a] + verts_list[b]) / 2.0
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return verts.astype(np.float32), faces


def deform_frame(verts: np.ndarray, t: float, identity_seed: int = 0) -> np.ndarray:
    """Smooth, frame-parameterised deformation: twist about y + bend.

    t=0 is the canonical (identity) pose."""
    rng_phase = identity_seed * 0.37
    angle = t * (0.8 + 0.2 * np.sin(rng_phase)) * verts[:, 1]
    ca, sa = np.cos(angle), np.sin(angle)
    x = ca * verts[:, 0] + sa * verts[:, 2]
    z = -sa * verts[:, 0] + ca * verts[:, 2]
    y = verts[:, 1] + 0.3 * t * np.sin(verts[:, 0] * 2.0 + rng_phase)
    return np.stack([x, y, z], axis=1).astype(np.float32)


def generate_synthetic_dataset(
    root: str,
    n_identities: int = 2,
    n_motions_per_identity: int = 1,
    n_frames: int = 3,
    n_surface: int = 400,
    n_space: int = 500,
    subdivisions: int = 1,
    seed: int = 0,
) -> dict:
    """Create the fixture; returns {'dataset_dir', 'split_dir', sequences...}."""
    rng = np.random.RandomState(seed)
    dataset_dir = os.path.join(root, "frames")
    split_dir = os.path.join(root, "splits")
    os.makedirs(dataset_dir, exist_ok=True)

    base_verts, faces = icosphere(subdivisions)
    sequences = []
    for ident in range(n_identities):
        iden_name = f"id{ident}"
        # fixed per-identity sample info, replayed on every frame
        face_idx, bary = meshio.sample_faces(base_verts, faces, n_surface, rng)
        space_face_idx, space_bary = meshio.sample_faces(
            base_verts, faces, n_space, rng
        )
        space_noise = np.concatenate(
            [
                0.1 * rng.randn(n_space // 2, 3),
                0.02 * rng.randn(n_space - n_space // 2, 3),
            ],
            axis=0,
        ).astype(np.float32)
        normals_base = meshio.face_normals(base_verts, faces)

        for motion in range(n_motions_per_identity):
            seq_name = f"{iden_name}_m{motion}"
            sequences.append(seq_name)
            for frame in range(n_frames):
                frame_name = f"{frame:04d}"
                frame_dir = os.path.join(dataset_dir, seq_name, frame_name)
                os.makedirs(frame_dir, exist_ok=True)

                t = frame / max(n_frames - 1, 1) * (0.5 + 0.5 * motion)
                verts = deform_frame(base_verts, t, identity_seed=ident)

                # identity normalisation matrix (already normalised shapes)
                np.savetxt(
                    os.path.join(frame_dir, "orig_to_gaps.txt"),
                    np.eye(4, dtype=np.float32),
                )
                tri = verts[faces[face_idx]]
                surface_points = (bary[:, :, None] * tri).sum(1).astype(np.float32)
                normals = normals_base[face_idx].astype(np.float32)
                np.savez(
                    os.path.join(frame_dir, "surface_points.npz"),
                    points=surface_points,
                    normals=normals,
                )
                tri_sp = verts[faces[space_face_idx]]
                space_points = (
                    (space_bary[:, :, None] * tri_sp).sum(1) + space_noise
                ).astype(np.float32)
                np.savez(
                    os.path.join(frame_dir, "flow.npz"), points=space_points
                )
                meshio.save_mesh(
                    os.path.join(frame_dir, "mesh_orig.obj"), verts, faces
                )

    # split files: all sequences in every split (tiny fixture)
    os.makedirs(os.path.join(split_dir, "deform4d"), exist_ok=True)
    for split in (
        "identity_seen",
        "identity_unseen",
        "train_seen",
        "test_unseen_motions",
        "test_unseen_identities",
    ):
        with open(os.path.join(split_dir, "deform4d", split + ".lst"), "w") as f:
            f.write("\n".join(sequences) + "\n")

    return {
        "dataset_dir": dataset_dir,
        "split_dir": split_dir,
        "sequences": sequences,
        "n_frames": n_frames,
    }


def generate_userhandle_dataset(
    root: str,
    names: Sequence[str] = ("cat0",),
    subdivisions: int = 1,
) -> dict:
    """Mesh-only fixture of the user-handle datasets (``tosca``; ``dogrec``
    reads the same layout): ``<root>/frames/<name>/0000/`` holds
    ``orig_to_gaps.txt`` (identity) and ``model_normalized.obj`` (an
    icosphere posed by :func:`deform_frame` at t = 0.2, each coordinate
    moved by seeded N(0, 0.01^2) noise: on the symmetric icosphere many
    point distances tie to within float32 rounding, and the FPS and kNN
    picks would then hang on it), and ``<root>/splits/tosca/`` the two test
    splits listing every name.  Returns {'dataset_dir', 'split_dir'}."""
    dataset_dir = os.path.join(root, "frames")
    split_dir = os.path.join(root, "splits")
    os.makedirs(os.path.join(split_dir, "tosca"), exist_ok=True)
    rng = np.random.RandomState(0)
    verts, faces = icosphere(subdivisions)
    for name in names:
        frame = os.path.join(dataset_dir, name, "0000")
        os.makedirs(frame, exist_ok=True)
        np.savetxt(os.path.join(frame, "orig_to_gaps.txt"), np.eye(4))
        posed = deform_frame(verts, 0.2, 1) + 0.01 * rng.randn(*verts.shape)
        meshio.save_mesh(
            os.path.join(frame, "model_normalized.obj"),
            posed.astype(np.float32), faces,
        )
    for split in ("test_unseen_identities", "identity_unseen"):
        with open(os.path.join(split_dir, "tosca", split + ".lst"), "w") as f:
            f.write("\n".join(names) + "\n")
    return {"dataset_dir": dataset_dir, "split_dir": split_dir}


def synthetic_config(
    fixture: dict,
    model_type: str = "forward",
    arbitrary: bool = False,
    n_surface: int = 128,
    n_space: int = 128,
    tiny_model: bool = True,
) -> dict:
    """A full config dict over the fixture, with a small model for tests."""
    if tiny_model:
        encoder_kwargs = dict(
            npoints_per_layer=[n_surface, 32, 16],
            nneighbor=8,
            nneighbor_reduced=6,
            nfinal_transformers=2,
            d_transformer=32,
            d_reduced=24,
            full_SA=True,
        )
        decoder_kwargs = dict(
            dim_inp=32, dim=20, nneigh=5, hidden_dim=16, out_dim=3
        )
    else:
        encoder_kwargs = dict(
            npoints_per_layer=[5000, 500, 100],
            nneighbor=16,
            nneighbor_reduced=10,
            nfinal_transformers=3,
            d_transformer=256,
            d_reduced=120,
            full_SA=True,
        )
        decoder_kwargs = dict(
            dim_inp=256, dim=200, nneigh=7, hidden_dim=128, out_dim=3
        )
    return {
        "experiment": {"out_dir": None, "name": "synthetic"},
        "data": {
            "type": "deform4d",
            "dataset_dir": fixture["dataset_dir"],
            "split_dir": fixture["split_dir"],
            "interval": 1,
            "arbitrary": arbitrary,
            "inverse": False,
            "fix_coord_system": False,
            "num_surf_samples": n_surface,
            "num_space_samples": n_space,
            "partial_range": 0.1,
            "noise_level": 0.0,
            "partial_shape_ratio": 1.0,
            "norm_params_file": "orig_to_gaps.txt",
            "surface_flow_file": "surface_points.npz",
            "space_flow_file": "flow.npz",
            "mesh_file": "mesh_orig.obj",
        },
        "model": {
            "type": model_type,
            "use_normals": False,
            "encoder": "pointransformer",
            "encoder_kwargs": encoder_kwargs,
            "decoder": "crossatten",
            "decoder_kwargs": decoder_kwargs,
        },
        "training": {
            "iden_split": "identity_seen",
            "motion_split": "train_seen",
            "load_mesh": False,
            "num_sampled_pairs": -1,
            "epochs": 2,
            "save_frequency": 1,
            "batch_size": 2,
            "optimizer": "Adam",
            "lr": 1e-3,
            "lr_step": 100,
            "lr_decay": 0.1,
            "weight_decay": 0.0,
        },
        "validation": {
            "iden_split": "identity_seen",
            "motion_split": "test_unseen_motions",
            "load_mesh": False,
            "num_sampled_pairs": -1,
            "frequency": 1,
            "batch_size": 2,
        },
        "test": {
            "iden_split": "identity_seen",
            "motion_split": "test_unseen_motions",
            "load_mesh": True,
            "num_sampled_pairs": 2,
            "batch_size": 1,
            "generate_mesh": True,
            "mesh_folder": "meshes",
            "mesh_format": "ply",
            "generate_pointcloud": True,
            "pointcloud_folder": "pointclouds",
            "pointcloud_format": "ply",
        },
        "logger": {"type": "wandb", "project": "NSDP-TPU"},
    }
