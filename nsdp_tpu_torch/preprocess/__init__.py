"""Offline dataset production (the port's own copy of ``nsdp_tpu/preprocess``).

Host code in both packages: numpy, scipy and the native C++ runtime
(:mod:`nsdp_tpu_torch.native`), computing the same files as the JAX
package's.  Nothing here runs on the card or imports torch.

Replaces the reference's preprocessing stack (GAPS C++ binaries + trimesh +
a shell fan-out, reference ``preprocess/``) with a self-contained
pipeline writing the identical on-disk contract:

``<out>/<sequence>/<frame>/{orig_to_gaps.txt, mesh_orig.obj,
model_normalized.obj, surface_points.npz, flow.npz}``

* :mod:`nsdp_tpu_torch.preprocess.anime` — DeformingThings4D ``.anime`` binary
  reader + per-frame mesh export;
* :mod:`nsdp_tpu_torch.preprocess.normalize` — PCA/centroid normalisation emitting
  the ``orig_to_gaps.txt`` 4x4 (GAPS ``msh2msh -scale_by_pca
  -translate_by_centroid -scale 0.35 -debug_matrix`` equivalent);
* :mod:`nsdp_tpu_torch.preprocess.flow` — correspondence-preserving surface/space
  flow sampling (fixed per-identity face indices + barycentric weights
  replayed across frames);
* :mod:`nsdp_tpu_torch.preprocess.watertight`,
  :mod:`nsdp_tpu_torch.preprocess.poisson` — the optional closed-manifold
  remesh (SDF rasterisation, screened Poisson);
* :mod:`nsdp_tpu_torch.preprocess.pipeline` — sequence-level drivers with a
  ``spawn`` process pool, and the CLI
  (``python -m nsdp_tpu_torch.preprocess <subcommand>``).
"""

from nsdp_tpu_torch.preprocess.anime import anime_read, convert_anime_to_meshes
from nsdp_tpu_torch.preprocess.normalize import (
    normalization_matrix,
    normalize_mesh_directory,
)
from nsdp_tpu_torch.preprocess.flow import (
    make_template_sample_info,
    write_surface_flow,
    write_space_flow,
)

__all__ = [
    "anime_read",
    "convert_anime_to_meshes",
    "normalization_matrix",
    "normalize_mesh_directory",
    "make_template_sample_info",
    "write_surface_flow",
    "write_space_flow",
]
