"""Test-time output generation: source/canonical/deformed/target/handle
meshes and point clouds (the port's own copy of
``nsdp_tpu/utils/generation.py``).

Same directory/file-name contract as the reference
(``utils/generation.py:7-161``): per-category subdirectories
(``source/ canonical/ deformed/ target/ handle/``), file names built from the
pair metadata, red source-handle / blue target-handle vertex coloring, an
error-colormap on the deformed mesh, and the handle-region submesh (faces
whose three vertices are all handles).
"""

import os
from typing import Dict

import numpy as np

from nsdp_tpu_torch.utils import meshio
from nsdp_tpu_torch.utils.visualize import error_map_colors

_GRAY = 0.75
_RED = np.array([255, 0, 0], dtype=np.uint8)
_BLUE = np.array([0, 0, 255], dtype=np.uint8)


def create_directory(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)


def create_directories_and_files(output_dir: str, meta_data: Dict, ext: str):
    (idx_cano, cano_seq, cano_frame, idx_motion, src_seq, src_frame,
     tgt_seq, tgt_frame) = meta_data["pair_info"]

    def sub(name, fname):
        d = os.path.join(output_dir, name)
        create_directory(d)
        return os.path.join(d, fname)

    pair = f"{src_seq}_{src_frame}_to_{tgt_seq}_{tgt_frame}.{ext}"
    return (
        sub("source", f"{src_seq}_{src_frame}.{ext}"),
        sub("canonical", f"{cano_seq}_{cano_frame}.{ext}"),
        sub("deformed", pair),
        sub("target", pair),
        sub("handle", pair),
    )


def _handle_colors(n: int, handle_mask: np.ndarray, handle_rgb: np.ndarray):
    colors = np.full((n, 3), int(_GRAY * 255), dtype=np.uint8)
    colors[handle_mask] = handle_rgb
    return colors


def generate_meshes(
    output_dir: str,
    out_dict: Dict,
    meta_data: Dict,
    ext: str,
    vert_pred_color: bool = False,
) -> None:
    files = create_directories_and_files(output_dir, meta_data, ext)
    src_file, cano_file, deform_file, target_file, handle_file = files

    verts_pred = np.asarray(out_dict["verts_tgt_pred"]).squeeze()
    verts_cano = np.asarray(out_dict["verts_cano"]).squeeze()
    verts_src = np.asarray(out_dict["verts_src"]).squeeze()
    verts_tgt = np.asarray(out_dict["verts_tgt"]).squeeze()
    handle = np.asarray(out_dict["cano_handle_vert_idx"]).squeeze().astype(bool)
    faces = np.asarray(out_dict["faces"]).squeeze()

    src_colors = _handle_colors(len(verts_src), handle, _RED)
    meshio.save_mesh(src_file, verts_src, faces, vertex_colors=src_colors)
    meshio.save_mesh(cano_file, verts_cano, faces, vertex_colors=src_colors)

    if vert_pred_color:
        err = np.sqrt(((verts_pred - verts_tgt) ** 2).sum(-1))
        meshio.save_mesh(
            deform_file, verts_pred, faces,
            vertex_colors=error_map_colors(err),
        )
    else:
        meshio.save_mesh(deform_file, verts_pred, faces)

    tgt_colors = _handle_colors(len(verts_tgt), handle, _BLUE)
    meshio.save_mesh(target_file, verts_tgt, faces, vertex_colors=tgt_colors)

    # handle submesh: faces whose three corners are all handle vertices
    face_mask = handle[faces].all(axis=1)
    meshio.save_mesh(
        handle_file, verts_tgt, faces[face_mask],
        vertex_colors=tgt_colors,
    )


def generate_pointclouds(
    output_dir: str, out_dict: Dict, meta_data: Dict, ext: str
) -> None:
    files = create_directories_and_files(output_dir, meta_data, ext)
    src_file, cano_file, deform_file, target_file, handle_file = files

    inputs = np.asarray(out_dict["surface_samples_inputs"]).squeeze()
    pc_deform = np.asarray(out_dict["surface_samples_tgt_pred"]).squeeze()
    pc_tgt = np.asarray(out_dict["surface_samples_tgt"]).squeeze()
    pc_cano = np.asarray(out_dict["surface_samples_cano"]).squeeze()
    if "surface_valid_mask" in out_dict:
        # static-shape partial shapes (data.pad_partial_shapes): drop the
        # zero-padded rows so saved clouds contain only real points
        valid = np.asarray(out_dict["surface_valid_mask"]).squeeze() != 0
        inputs = inputs[valid]
        pc_deform, pc_tgt, pc_cano = (
            pc_deform[valid], pc_tgt[valid], pc_cano[valid]
        )
    # With use_normals the conditioning is 10-channel
    # [src(3), normals(3), masked tgt(3), mask(1)]; slice accordingly.
    pc_src = inputs[:, 0:3]
    pc_handle = inputs[:, -4:-1]
    handle_mask = inputs[:, -1] > 0

    meshio.save_pointcloud(
        src_file, pc_src, _handle_colors(len(pc_src), handle_mask, _RED)
    )
    meshio.save_pointcloud(
        cano_file, pc_cano, _handle_colors(len(pc_cano), handle_mask, _RED)
    )
    meshio.save_pointcloud(deform_file, pc_deform)
    meshio.save_pointcloud(
        target_file, pc_tgt, _handle_colors(len(pc_tgt), handle_mask, _BLUE)
    )
    meshio.save_pointcloud(
        handle_file,
        pc_handle[handle_mask],
        np.tile(_BLUE, (int(handle_mask.sum()), 1)),
    )


def define_userhandle_folder_name(cfg: Dict) -> str:
    """Output dirname encoding handle choice + translation, e.g.
    ``drag_head_x-0.15y-0.20z-0.20_ratio0.10`` (reference
    ``utils/generation.py:129-161``)."""
    uh = cfg["data"]["userhandle"]
    dirname = "drag"
    for region in (
        "head",
        "tail",
        "frontleftfoot",
        "frontrightfoot",
        "behindleftfoot",
        "behindrightfoot",
    ):
        if uh.get(region, False):
            dirname += "_" + region
            break
    dirname += "_x%.2fy%.2fz%.2f" % (
        uh.get("xtrans", 0.0),
        uh.get("ytrans", 0.0),
        uh.get("ztrans", 0.0),
    )
    dirname += "_ratio%.2f" % cfg["data"]["partial_range"]
    if uh.get("cliptail", False):
        dirname += "_cliptail"
    return dirname
