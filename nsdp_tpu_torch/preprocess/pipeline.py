"""Sequence-level preprocessing drivers with process fan-out.

The port's own copy of ``nsdp_tpu/preprocess/pipeline.py``, the same
outputs, with one change: the fan-out (:func:`_fan_out`) is the standard
library's ``concurrent.futures.ProcessPoolExecutor`` on a ``spawn``
context, where the JAX package uses joblib.  Spawned workers start clean,
so a caller that holds a CUDA context or threads of its own can fan out
safely (forking such a process is not), and no joblib is needed.  Results
come back in submission order, and every random draw of the flows (the
per-identity templates) is made in the parent, so the outputs do not
depend on the pool.

Pure-Python equivalents of the reference driver scripts
(``preprocess/generate_dataset_*_{seq,surfaceflow,spaceflow}.py`` and
``generate_dataset_nocorr.py``), sharing one fan-out helper.  The shell
entry points become the CLI in :mod:`nsdp_tpu_torch.preprocess.__main__`:

  python -m nsdp_tpu_torch.preprocess deform4d       --input_mesh_dir ... --output_data_dir ...
  python -m nsdp_tpu_torch.preprocess deformtransfer --input_mesh_dir ... --output_data_dir ...
  python -m nsdp_tpu_torch.preprocess nocorr         --input_mesh_dir ... --output_data_dir ...
  python -m nsdp_tpu_torch.preprocess anime          --in_folder ...      --mesh_folder ...
"""

import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from nsdp_tpu_torch.preprocess.anime import convert_anime_to_meshes
from nsdp_tpu_torch.preprocess.flow import (
    make_template_sample_info,
    write_space_flow,
    write_surface_flow,
)
from nsdp_tpu_torch.preprocess.normalize import (
    normalize_mesh_directory,
    normalize_mesh_file,
)


def _n_workers(n_jobs: int) -> int:
    """joblib's reading of ``n_jobs``: ``-1`` all CPUs, ``-2`` all but one,
    and so on; 0 is refused."""
    if n_jobs == 0:
        raise ValueError("n_jobs == 0 has no meaning")
    if n_jobs < 0:
        return max(os.cpu_count() + 1 + n_jobs, 1)
    return n_jobs


def _fan_out(fn: Callable, jobs: Sequence[tuple], n_jobs: int) -> list:
    """``[fn(*job) for job in jobs]``, in that order: in this process when
    ``n_jobs`` comes to one worker (as joblib runs ``n_jobs=1``), else on a
    pool of ``spawn`` processes.  ``fn`` and the jobs must pickle."""
    workers = _n_workers(n_jobs)
    if workers == 1 or not jobs:
        return [fn(*job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(jobs)), mp_context=ctx) as pool:
        return list(pool.map(fn, *zip(*jobs)))


def _read_list(path: Optional[str]) -> Optional[List[str]]:
    if path is None:
        return None
    with open(path, "r") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _sequence_dirs(mesh_directory: str, filter_lst: Optional[str]) -> List[str]:
    selected = _read_list(filter_lst)
    out = []
    for name in sorted(os.listdir(mesh_directory)):
        if not os.path.isdir(os.path.join(mesh_directory, name)):
            continue
        if selected is not None and name not in selected:
            continue
        out.append(name)
    return out


def convert_anime_folder(
    in_folder: str, mesh_folder: str, out_ext: str = "obj", n_jobs: int = -1
) -> int:
    """Convert every ``<in_folder>/<model>/*.anime`` to per-frame meshes."""
    jobs = []
    for model in sorted(os.listdir(in_folder)):
        model_dir = os.path.join(in_folder, model)
        if not os.path.isdir(model_dir):
            continue
        for fname in sorted(os.listdir(model_dir)):
            if fname.endswith(".anime"):
                stem = os.path.splitext(fname)[0]
                jobs.append(
                    (os.path.join(model_dir, fname),
                     os.path.join(mesh_folder, stem), out_ext)
                )
    _fan_out(convert_anime_to_meshes, jobs, n_jobs)
    return len(jobs)


def generate_sequences(
    mesh_directory: str,
    dataset_directory: str,
    mesh_format: str = "obj",
    interval: int = 3,
    filter_lst: Optional[str] = None,
    skip_existing: bool = True,
    n_jobs: int = -1,
    make_watertight: bool = False,
    watertight_spacing: float = 0.005,
    watertight_method: str = "sdf",
    watertight_depth: int = 8,
) -> int:
    """Normalise every ``interval``-th frame of every sequence (stage 'seq').

    ``make_watertight`` runs a closed-manifold remesh before normalisation
    (off by default, like the reference's ``process_mesh_local.sh:22``).
    ``watertight_method='sdf'`` is the msh2df-equivalent SDF rasterisation;
    ``watertight_spacing`` is its grid resolution (reference flag
    ``-spacing 0.005``; cost scales with (extent/spacing)^3 — the numpy
    implementation wants ~0.02-0.05 on unit-scale meshes where GAPS's C++
    used 0.005).  ``watertight_method='poisson'`` is the reference's active
    meshlab screened-Poisson recipe (``make_watertight.sh:19``) with
    ``watertight_depth`` as the .mlx octree depth."""
    seqs = _sequence_dirs(mesh_directory, filter_lst)
    os.makedirs(dataset_directory, exist_ok=True)
    normalize = functools.partial(
        normalize_mesh_directory,
        make_watertight=make_watertight,
        watertight_spacing=watertight_spacing,
        watertight_method=watertight_method,
        watertight_depth=watertight_depth,
    )
    counts = _fan_out(normalize, [
        (os.path.join(mesh_directory, seq), os.path.join(dataset_directory, seq),
         mesh_format, interval, skip_existing)
        for seq in seqs
    ], n_jobs)
    return int(sum(counts))


def _write_flows(mesh_path: str, frame_dir: str, info: Dict) -> None:
    """Both flow files of one frame from its identity's sample info."""
    write_surface_flow(mesh_path, frame_dir, info)
    write_space_flow(mesh_path, frame_dir, info)


def generate_flows(
    mesh_directory: str,
    dataset_directory: str,
    temp_lst: str,
    mesh_format: str = "obj",
    interval: int = 3,
    surface_count: int = 100000,
    space_count: int = 200000,
    skip_existing: bool = True,
    n_jobs: int = -1,
    seed: Optional[int] = None,
    template_frame: str = "0000",
) -> int:
    """Write surface_points.npz + flow.npz for every processed frame.

    One sample-info draw per identity template (``temp_lst`` names the
    template sequences; identity = name before the first '_'), replayed on
    every frame of every sequence of that identity.
    """
    rng = np.random.RandomState(seed) if seed is not None else np.random
    sample_info: Dict[str, Dict] = {}
    for seq in _read_list(temp_lst) or []:
        identity = seq.split("_")[0]
        template_path = os.path.join(
            mesh_directory, seq, f"{template_frame}.{mesh_format}"
        )
        if not os.path.exists(template_path):
            print(f"template mesh missing: {template_path}")
            continue
        sample_info[identity] = make_template_sample_info(
            template_path, surface_count, space_count, rng=rng
        )

    jobs = []
    for seq in _sequence_dirs(mesh_directory, None):
        identity = seq.split("_")[0]
        if identity not in sample_info:
            print(f"{seq} is not in the selected templates")
            continue
        frames = sorted(
            f
            for f in os.listdir(os.path.join(mesh_directory, seq))
            if f.endswith("." + mesh_format)
        )
        frames = [frames[i] for i in range(len(frames)) if i % interval == 0]
        for fname in frames:
            stem = os.path.splitext(fname)[0]
            frame_dir = os.path.join(dataset_directory, seq, stem)
            if not os.path.isfile(os.path.join(frame_dir, "orig_to_gaps.txt")):
                continue  # frame was not normalised (stage 'seq' skipped it)
            if skip_existing and os.path.isfile(
                os.path.join(frame_dir, "surface_points.npz")
            ) and os.path.isfile(os.path.join(frame_dir, "flow.npz")):
                continue
            jobs.append((os.path.join(mesh_directory, seq, fname), frame_dir,
                         sample_info[identity]))

    _fan_out(_write_flows, jobs, n_jobs)
    return len(jobs)


def generate_nocorr(
    mesh_directory: str,
    dataset_directory: str,
    mesh_format: str = "off",
    filter_lst: Optional[str] = None,
    skip_existing: bool = True,
    n_jobs: int = -1,
) -> int:
    """Normalisation-only datasets (TOSCA / dogrec): each mesh file of each
    model directory becomes ``<dataset>/<model>/<idx:04d>/`` with
    ``orig_to_gaps.txt`` + ``mesh_orig`` + ``model_normalized.obj``."""
    jobs = []
    for model in _sequence_dirs(mesh_directory, filter_lst):
        model_dir = os.path.join(mesh_directory, model)
        files = sorted(
            f for f in os.listdir(model_dir) if f.endswith("." + mesh_format)
        )
        for idx, fname in enumerate(files):
            out_dir = os.path.join(dataset_directory, model, f"{idx:04d}")
            if skip_existing and os.path.isfile(
                os.path.join(out_dir, "orig_to_gaps.txt")
            ):
                continue
            jobs.append((os.path.join(model_dir, fname), out_dir))

    _fan_out(normalize_mesh_file, jobs, n_jobs)
    return len(jobs)
