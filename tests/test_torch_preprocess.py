"""The port's preprocessing against the JAX package's, bit for bit.

``nsdp_tpu_torch.preprocess`` (``anime``, ``normalize``, ``flow``,
``watertight``, ``poisson`` and the ``python -m`` entry point) on the same
inputs as ``nsdp_tpu.preprocess``: synthetic ``icosphere(1)``-
``icosphere(3)`` meshes, deformed by ``deform_frame``, and random draws from
a numpy seed; watertight remeshing at coarse spacing.  Arrays equal bit for
bit, text and mesh files byte for byte; a written tree file for file, its
``.npz`` arrays bit for bit (their zip timestamps differ).  The CLIs run in
process through ``main(argv)``, with ``--seed 0`` and one worker (and the
global ``np.random``, which watertight remeshing draws from, seeded alike);
one more run of the port takes 2 workers, so its ``spawn`` pool is
exercised, and writes the same tree.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from nsdp_tpu.preprocess import __main__ as jax_cli
from nsdp_tpu.preprocess import anime as jax_anime
from nsdp_tpu.preprocess import flow as jax_flow
from nsdp_tpu.preprocess import normalize as jax_normalize
from nsdp_tpu.preprocess import poisson as jax_poisson
from nsdp_tpu.preprocess import watertight as jax_watertight
from nsdp_tpu_torch.data.datasets import Deform4DFlowDataset
from nsdp_tpu_torch.data.synthetic import deform_frame, icosphere, synthetic_config
from nsdp_tpu_torch.preprocess import __main__ as cli
from nsdp_tpu_torch.preprocess import anime, flow, normalize, poisson, watertight
from nsdp_tpu_torch.preprocess.pipeline import _n_workers
from nsdp_tpu_torch.utils import meshio


def _same(got, want):
    """Nested tuples/lists/dicts of arrays (and scalars) equal bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        bits = lambda a: a.reshape(-1).view(np.uint8)
        np.testing.assert_array_equal(bits(got), bits(want))


def _same_tree(got: Path, want: Path):
    """Two written directories: the same files; ``.npz`` arrays bit for bit,
    everything else byte for byte."""
    names = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    assert names(got) == names(want) != []
    for name in names(want):
        if name.endswith(".npz"):
            with np.load(got / name) as g, np.load(want / name) as w:
                _same(dict(g), dict(w))
        else:
            assert (got / name).read_bytes() == (want / name).read_bytes(), name


def _holed(subdivisions):
    """An icosphere with a cap cut off: an open mesh to close."""
    verts, faces = icosphere(subdivisions)
    cent = verts[faces].mean(1)
    return verts, faces[cent[:, 2] < 0.8]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """``<root>/raw/id<i>/id<i>_walk.anime``: two identities, 4 frames of a
    deformed ``icosphere(2)`` each."""
    root = tmp_path_factory.mktemp("raw")
    verts, faces = icosphere(2)
    for ident in range(2):
        model_dir = root / "raw" / f"id{ident}"
        model_dir.mkdir(parents=True)
        frames = [deform_frame(verts, t / 3.0, ident) for t in range(4)]
        offsets = np.stack([f - frames[0] for f in frames[1:]])
        anime.anime_write(str(model_dir / f"id{ident}_walk.anime"), frames[0], faces, offsets)
    (root / "templates.lst").write_text("id0_walk\nid1_walk\n")
    return root


# ---------------------------------------------------------------- modules


def test_anime_matches_jax(raw, tmp_path):
    path = str(raw / "raw" / "id1" / "id1_walk.anime")
    got = anime.anime_read(path)
    _same(got, jax_anime.anime_read(path))
    nf, _, _, v0, faces, offsets = got
    anime.anime_write(str(tmp_path / "port.anime"), v0, faces, offsets)
    jax_anime.anime_write(str(tmp_path / "jax.anime"), v0, faces, offsets)
    assert (tmp_path / "port.anime").read_bytes() == (tmp_path / "jax.anime").read_bytes()
    for side, module in (("port", anime), ("jax", jax_anime)):
        assert module.convert_anime_to_meshes(path, str(tmp_path / side / "m"), "off") == nf
    _same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("subdivisions", [1, 2, 3])
def test_normalize_matches_jax(tmp_path, subdivisions):
    verts, faces = icosphere(subdivisions)
    verts = deform_frame(verts, 0.7, subdivisions) * np.array([3.0, 1.0, 0.5]) + 7.0
    _same(normalize.normalization_matrix(verts, 0.3),
          jax_normalize.normalization_matrix(verts, 0.3))
    mesh = tmp_path / "in.obj"
    meshio.save_mesh(str(mesh), verts.astype(np.float32), faces)
    for side, module in (("port", normalize), ("jax", jax_normalize)):
        module.normalize_mesh_file(str(mesh), str(tmp_path / side / "0000"))
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_flow_matches_jax(tmp_path):
    verts, faces = icosphere(3)
    template = tmp_path / "template.obj"
    meshio.save_mesh(str(template), verts, faces)
    info = flow.make_template_sample_info(str(template), 500, 700,
                                          rng=np.random.RandomState(0))
    _same(info, jax_flow.make_template_sample_info(str(template), 500, 700,
                                                   rng=np.random.RandomState(0)))
    frame = tmp_path / "frame.obj"
    meshio.save_mesh(str(frame), deform_frame(verts, 0.5, 1).astype(np.float32), faces)
    for side, module in (("port", normalize), ("jax", jax_normalize)):
        module.normalize_mesh_file(str(frame), str(tmp_path / side))
    for float16 in (True, False):
        for side, module in (("port", flow), ("jax", jax_flow)):
            module.write_surface_flow(str(frame), str(tmp_path / side), info, float16)
            module.write_space_flow(str(frame), str(tmp_path / side), info, float16)
        _same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("subdivisions", [1, 2, 3])
def test_watertight_matches_jax(tmp_path, subdivisions):
    verts, faces = _holed(subdivisions)
    kw = dict(spacing=0.15, n_samples=4000)
    _same(watertight.mesh_to_signed_distance_grid(verts, faces, rng=np.random.RandomState(1),
                                                  **kw),
          jax_watertight.mesh_to_signed_distance_grid(verts, faces,
                                                      rng=np.random.RandomState(1), **kw))
    got = watertight.watertight_mesh(verts, faces, rng=np.random.RandomState(2), **kw)
    _same(got, jax_watertight.watertight_mesh(verts, faces, rng=np.random.RandomState(2), **kw))
    assert len(got[1]) > 0
    mesh = tmp_path / "open.obj"
    meshio.save_mesh(str(mesh), verts, faces)
    for side, module in (("port", watertight), ("jax", jax_watertight)):
        (tmp_path / side).mkdir()
        module.watertight_mesh_file(str(mesh), str(tmp_path / side / "w.ply"),
                                    rng=np.random.RandomState(3), **kw)
    _same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("subdivisions", [1, 2, 3])
def test_poisson_matches_jax(subdivisions):
    verts, faces = _holed(subdivisions)
    rng = np.random.RandomState(subdivisions)
    points = rng.randn(3000, 3)
    normals = points / np.linalg.norm(points, axis=1, keepdims=True)
    kw = dict(depth=4, scale=1.2, point_weight=2.0)
    got = poisson.poisson_reconstruct(points, normals, **kw)
    _same(got, jax_poisson.poisson_reconstruct(points, normals, **kw))
    assert len(got[1]) > 0
    _same(poisson.watertight_mesh_poisson(verts, faces, depth=5, n_samples=3000,
                                          rng=np.random.RandomState(4)),
          jax_poisson.watertight_mesh_poisson(verts, faces, depth=5, n_samples=3000,
                                              rng=np.random.RandomState(4)))


def test_workers_read_n_jobs_as_joblib_does():
    assert _n_workers(1) == 1 and _n_workers(3) == 3
    assert _n_workers(-1) == os.cpu_count()
    assert _n_workers(-2) == max(os.cpu_count() - 1, 1)
    with pytest.raises(ValueError):
        _n_workers(0)


# ---------------------------------------------------------------- the CLIs


def _run(module, argv, seed=0):
    np.random.seed(seed)  # watertight remeshing draws from the global stream
    module.main(argv)


@pytest.fixture(scope="module")
def meshes(raw, tmp_path_factory):
    """Both CLIs' ``anime`` on the raw fixture (the same tree), the port's
    meshes returned."""
    root = tmp_path_factory.mktemp("meshes")
    for side, module in (("port", cli), ("jax", jax_cli)):
        _run(module, ["anime", "--in_folder", str(raw / "raw"), "--mesh_folder",
                      str(root / side), "--n_proc", "1"])
    _same_tree(root / "port", root / "jax")
    return root / "port"


DEFORM4D = {
    "plain": ["--interval", "1"],
    "watertight_sdf": ["--make_watertight", "--watertight_spacing", "0.15"],
    "watertight_poisson": ["--make_watertight", "--watertight_method", "poisson",
                           "--watertight_depth", "5"],
}


@pytest.mark.parametrize("case", sorted(DEFORM4D))
def test_deform4d_cli_matches_jax(raw, meshes, tmp_path, case):
    argv = ["deform4d", "--input_mesh_dir", str(meshes), "--temp_lst",
            str(raw / "templates.lst"), "--surface_count", "300", "--space_count", "400",
            "--seed", "0", *DEFORM4D[case]]
    for side, module in (("port", cli), ("jax", jax_cli)):
        _run(module, [*argv, "--output_data_dir", str(tmp_path / side), "--max_threads", "1"])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    if case == "plain":  # the pool: 2 spawned workers write the same tree
        _run(cli, [*argv, "--output_data_dir", str(tmp_path / "pool"), "--max_threads", "2"])
        _same_tree(tmp_path / "pool", tmp_path / "jax")
        split_dir = tmp_path / "splits" / "deform4d"
        split_dir.mkdir(parents=True)
        for split in ("identity_seen", "train_seen", "test_unseen_motions"):
            (split_dir / f"{split}.lst").write_text("id0_walk\nid1_walk\n")
        cfg = synthetic_config({"dataset_dir": str(tmp_path / "pool"),
                                "split_dir": str(tmp_path / "splits")},
                               n_surface=128, n_space=128)
        ds = Deform4DFlowDataset(cfg, "identity_seen", "test_unseen_motions", load_mesh=True,
                                 rng=np.random.RandomState(0))
        assert len(ds) == 8 and ds[0]["surface_samples_inputs"].shape == (128, 7)


def test_nocorr_cli_matches_jax(tmp_path):
    for model, sub in (("cat", 1), ("dog", 2)):
        raw = tmp_path / "raw" / model
        raw.mkdir(parents=True)
        verts, faces = icosphere(sub)
        for i in range(2):
            meshio.save_mesh(str(raw / f"{model}{i}.off"), deform_frame(verts, i / 2, sub), faces)
    (tmp_path / "filter.lst").write_text("dog\n")
    for argv in ([], ["--filter_lst", str(tmp_path / "filter.lst")]):
        out = tmp_path / ("filtered" if argv else "all")
        for side, module in (("port", cli), ("jax", jax_cli)):
            _run(module, ["nocorr", "--input_mesh_dir", str(tmp_path / "raw"),
                          "--output_data_dir", str(out / side), "--max_threads", "1", *argv])
        _same_tree(out / "port", out / "jax")
    assert sorted(os.listdir(tmp_path / "filtered" / "port")) == ["dog"]
