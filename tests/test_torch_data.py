"""The port's data pipeline, metrics, writers and logger == the JAX package's.

Everything here is numpy on both sides, so the comparisons are exact
(``np.array_equal``, byte-identical files), except the Chamfer metric's
nearest-neighbour search: scipy's KD-tree in the port, the JAX package's
native search where it is built (both exact; rtol 1e-6).
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nsdp_tpu.data as jax_data
import nsdp_tpu.data.loader as jax_loader
import nsdp_tpu.data.synthetic as jax_synthetic
import nsdp_tpu.training.steps as jax_steps
import nsdp_tpu.utils.generation as jax_generation
import nsdp_tpu.utils.logger as jax_logger
import nsdp_tpu.utils.meshio as jax_meshio
import nsdp_tpu.utils.metrics as jax_metrics
import nsdp_tpu.utils.padding as jax_padding
import nsdp_tpu_torch.data as port_data
import nsdp_tpu_torch.data.loader as port_loader
import nsdp_tpu_torch.data.synthetic as port_synthetic
import nsdp_tpu_torch.training.steps as port_steps
import nsdp_tpu_torch.utils.generation as port_generation
import nsdp_tpu_torch.utils.logger as port_logger
import nsdp_tpu_torch.utils.meshio as port_meshio
import nsdp_tpu_torch.utils.metrics as port_metrics
import nsdp_tpu_torch.utils.padding as port_padding

HANDLES = ("head", "tail", "frontleftfoot", "frontrightfoot", "behindleftfoot",
           "behindrightfoot")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    return port_synthetic.generate_synthetic_dataset(
        str(root), n_identities=2, n_motions_per_identity=1, n_frames=3, n_surface=200,
        n_space=300,
    )


@pytest.fixture(scope="module")
def dt_fixture(tmp_path_factory):
    """DeformationTransfer layout: sequences named after the animals whose
    fixed source frames differ (cat 0003, horse 0005), as
    ``tests/test_datasets_variants.py`` builds it."""
    root = tmp_path_factory.mktemp("torch_dt")
    fx = port_synthetic.generate_synthetic_dataset(
        str(root), n_identities=1, n_motions_per_identity=1, n_frames=6, n_surface=200)
    base = fx["dataset_dir"]
    os.rename(os.path.join(base, "id0_m0"), os.path.join(base, "cat_poses"))
    os.symlink(os.path.join(base, "cat_poses"), os.path.join(base, "horse_gallop"))
    os.makedirs(os.path.join(fx["split_dir"], "deformtransfer"))
    for split in ("identity_unseen", "test_unseen_identities"):
        with open(os.path.join(fx["split_dir"], "deformtransfer", split + ".lst"), "w") as f:
            f.write("cat_poses\nhorse_gallop\n")
    return fx


@pytest.fixture(scope="module")
def uh_fixture(tmp_path_factory):
    return port_synthetic.generate_userhandle_dataset(
        str(tmp_path_factory.mktemp("torch_uh")), names=("cat0", "dog1"), subdivisions=2)


def test_synthetic_fixture_matches_jax(tmp_path):
    """The port's fixture writer writes the JAX package's files (npz
    archives by their arrays: their zip entries carry a time stamp) and
    the same config."""
    kw = dict(n_identities=2, n_motions_per_identity=2, n_frames=2, n_surface=50, n_space=60)
    fj = jax_synthetic.generate_synthetic_dataset(str(tmp_path / "jax"), **kw)
    fp = port_synthetic.generate_synthetic_dataset(str(tmp_path / "port"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 2 * 2 * 2 * 4 + 5
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za) == sorted(zb)
            assert all(np.array_equal(za[k], zb[k]) for k in za)
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    for kw2 in ({}, dict(model_type="arbitrary", arbitrary=True, tiny_model=False)):
        cj, cp = jax_synthetic.synthetic_config(fj, **kw2), port_synthetic.synthetic_config(fp, **kw2)
        for c in (cj, cp):
            c["data"].pop("dataset_dir"), c["data"].pop("split_dir")
        assert cj == cp
    vj, fj_ = jax_synthetic.icosphere(3)
    vp, fp_ = port_synthetic.icosphere(3)
    assert np.array_equal(vj, vp) and np.array_equal(fj_, fp_)


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and np.array_equal(x, y), key


def _hold_datasets(cfg, iden_split, motion_split, num_sampled_pairs=-1):
    """Both packages' ``dataset_dict[type]`` on ``cfg``, with the global
    ``np.random`` seeded the same before each: every item and pair equal."""
    made = []
    for data in (jax_data, port_data):
        np.random.seed(11)
        made.append(data.dataset_dict[cfg["data"]["type"]](
            cfg, iden_split, motion_split, load_mesh=True,
            num_sampled_pairs=num_sampled_pairs))
    dj, dp = made
    assert len(dj) == len(dp) > 0
    # twice over the pairs: a train split reshuffles after its last index
    for i in list(range(len(dj))) * 2:
        assert dj.get_metadata(i) == dp.get_metadata(i)
        _assert_items_equal(dj[i], dp[i])
    return dp


DEFORM4D_CASES = {
    "forward": {},
    "inverse": dict(inverse=True),
    "arbitrary": dict(arbitrary=True),
    "arbitrary_train": dict(arbitrary=True, split="train_seen", pairs=5),
    "noise_normals": dict(noise_level=0.01, use_normals=True),
    "partial": dict(partial_shape_ratio=0.6),
    "partial_padded": dict(partial_shape_ratio=0.6, pad_partial_shapes=True),
    "subsampled_space": dict(num_space_samples=100, fix_coord_system=True),
}


@pytest.mark.parametrize("case", sorted(DEFORM4D_CASES))
def test_deform4d_items_match_jax(fixture, case):
    kw = dict(DEFORM4D_CASES[case])
    split, pairs = kw.pop("split", "test_unseen_motions"), kw.pop("pairs", -1)
    cfg = port_synthetic.synthetic_config(fixture, arbitrary=kw.pop("arbitrary", False))
    cfg["model"]["use_normals"] = kw.pop("use_normals", False)
    cfg["data"].update(kw)
    ds = _hold_datasets(cfg, "identity_seen", split, pairs)
    if case == "partial_padded":
        assert "surface_valid_mask" in ds[0] and ds[0]["surface_valid_mask"].min() == 0.0


def test_deformtransfer_items_match_jax(dt_fixture):
    cfg = port_synthetic.synthetic_config(dt_fixture, arbitrary=True)
    cfg["data"].update(type="deformtransfer", fix_coord_system=True)
    ds = _hold_datasets(cfg, "identity_unseen", "test_unseen_identities")
    assert {p["pair_info"][5] for p in ds.all_deform_pairs} == {"0003", "0005"}


@pytest.mark.parametrize("handle", HANDLES + ("tail_cliptail", "head_partial_padded"))
def test_userhandle_items_match_jax(uh_fixture, handle):
    """``tosca`` with each user handle (and ``dogrec``, the same class),
    and the output folder name ``run.py`` derives from it."""
    region = handle.split("_")[0]
    cfg = port_synthetic.synthetic_config(uh_fixture, arbitrary=True)
    cfg["data"].update(type="tosca", mesh_file="model_normalized.obj")
    cfg["data"]["userhandle"] = dict({r: r == region for r in HANDLES},
                                     cliptail=handle.endswith("cliptail"),
                                     xtrans=-0.15, ytrans=-0.2, ztrans=0.1)
    if handle.endswith("partial_padded"):
        cfg["data"].update(partial_shape_ratio=0.7, pad_partial_shapes=True)
    _hold_datasets(cfg, "identity_unseen", "test_unseen_identities")
    assert (port_generation.define_userhandle_folder_name(cfg)
            == jax_generation.define_userhandle_folder_name(cfg))
    assert port_data.dataset_dict["dogrec"] is port_data.dataset_dict["tosca"]


class _Indexed:
    """A dataset whose items depend only on their index, so a loader's
    worker threads cannot reorder random draws."""

    collate_fn = staticmethod(port_data.Deform4DFlowDataset.collate_fn)

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return {"x": np.full((3, 2), i, np.float32), "index": i}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(fixture, workers, drop_last):
    kw = dict(batch_size=3, shuffle=True, drop_last=drop_last, num_workers=workers, seed=5)
    got = list(port_data.DataLoader(_Indexed(), **kw))
    want = list(jax_data.DataLoader(_Indexed(), collate_fn=_Indexed.collate_fn, **kw))
    assert len(got) == len(want) == len(port_data.DataLoader(_Indexed(), **kw))
    for a, b in zip(got, want):
        _assert_items_equal(a, b)
    # the real dataset, synchronously (its random draws are then in order)
    cfg = port_synthetic.synthetic_config(fixture, arbitrary=True)
    batches = []
    for data in (jax_data, port_data):
        np.random.seed(3)
        ds = data.dataset_dict["deform4d"](cfg, "identity_seen", "test_unseen_motions",
                                           load_mesh=True)
        batches.append(list(data.DataLoader(ds, batch_size=2)))
    assert len(batches[0]) == len(batches[1]) == 2
    for a, b in zip(*batches):
        _assert_items_equal(a, b)


def test_split_batch_matches_jax():
    batch = {"surface_samples_inputs": np.arange(24.0).reshape(2, 4, 3),
             "index": np.array([4, 9]), "name": "meta"}
    got = list(port_loader.split_batch(batch))
    want = list(jax_loader.split_batch(batch))
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a["name"] == b["name"] == "meta"
        _assert_items_equal({k: v for k, v in a.items() if k != "name"},
                            {k: v for k, v in b.items() if k != "name"})
    bad = dict(batch, faces=np.zeros((5, 3)))
    for split in (port_loader.split_batch, jax_loader.split_batch):
        with pytest.raises(ValueError, match="faces"):
            list(split(bad))
    assert len(list(port_loader.split_batch(bad, passthrough=("faces",)))) == 2


def _pair(rng):
    """One pair's batch-1 arrays as ``test_on_batch`` leaves them."""
    verts, faces = port_synthetic.icosphere(2)
    handle = (verts[:, 1] < -0.5).astype(np.float32)[:, None]
    n = 40
    inputs = rng.randn(n, 7).astype(np.float32)
    inputs[:, 6] = rng.rand(n) > 0.5
    valid = np.ones(n, np.float32)
    valid[-5:] = 0.0
    return {
        "verts_tgt_pred": (verts + 0.05 * rng.randn(*verts.shape)).astype(np.float32)[None],
        "verts_tgt": verts[None], "verts_src": (verts * 0.9)[None], "verts_cano": verts[None],
        "cano_handle_vert_idx": handle[None], "faces": faces[None],
        "surface_samples_inputs": inputs[None],
        "surface_samples_tgt_pred": rng.randn(1, n, 3).astype(np.float32),
        "surface_samples_tgt": rng.randn(1, n, 3).astype(np.float32),
        "surface_samples_cano": rng.randn(1, n, 3).astype(np.float32),
        "surface_valid_mask": valid[None],
    }


def test_metrics_match_jax(rng):
    sample = _pair(rng)
    got = [port_metrics.compute_evaluation_metrics(sample, rng=np.random.RandomState(s))
           for s in (0, 1)]
    want = [jax_metrics.compute_evaluation_metrics(sample, rng=np.random.RandomState(s))
            for s in (0, 1)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["cd", "fnc", "l2"]
        assert g == w  # one native KD-tree in both packages: bit for bit
    assert got[0]["cd"] != got[1]["cd"]  # the seed reaches the 30k samples
    # the global stream, as test.py uses it
    np.random.seed(2)
    g = port_metrics.compute_evaluation_metrics(sample)
    np.random.seed(2)
    w = jax_metrics.compute_evaluation_metrics(sample)
    assert g == w


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ext", ["ply", "obj"])
def test_writers_match_jax(tmp_path, rng, masked, ext):
    """Meshes (error-colored and plain) and point clouds, byte for byte."""
    sample = _pair(rng)
    if not masked:
        del sample["surface_valid_mask"]
    meta = {"pair_info": (0, "id0_m0", "0000", 0, "id0_m0", "0000", "id0_m0", "0002")}
    for side, gen in (("jax", jax_generation), ("port", port_generation)):
        gen.generate_meshes(str(tmp_path / side / "m"), sample, meta, ext, vert_pred_color=True)
        gen.generate_meshes(str(tmp_path / side / "p"), sample, meta, ext, vert_pred_color=False)
        gen.generate_pointclouds(str(tmp_path / side / "c"), sample, meta, "ply")
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 15
    for rel in files:
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes(), rel


@pytest.mark.parametrize("ext", ["obj", "off", "ply"])
def test_meshio_matches_jax(tmp_path, rng, ext):
    verts, faces = port_synthetic.icosphere(1)
    colors = (rng.rand(len(verts), 3) * 255).astype(np.uint8) if ext != "off" else None
    for side, mio in (("jax", jax_meshio), ("port", port_meshio)):
        mio.save_mesh(str(tmp_path / f"{side}.{ext}"), verts, faces, vertex_colors=colors)
    assert (tmp_path / f"jax.{ext}").read_bytes() == (tmp_path / f"port.{ext}").read_bytes()
    for a, b in zip(jax_meshio.load_mesh(str(tmp_path / f"jax.{ext}")),
                    port_meshio.load_mesh(str(tmp_path / f"jax.{ext}"))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(port_meshio.load_mesh(str(tmp_path / f"port.{ext}"))[0], verts,
                               rtol=1e-6)


def test_stats_logger_lines_match_jax():
    """The printed progress lines (running means) are the same text."""
    texts = []
    for mod in (jax_logger, port_logger):
        mod.StatsLogger.reset()
        logger = mod.StatsLogger.instance()
        out = io.StringIO()
        logger._output_files = [out]
        for b, (loss, l2, cd) in enumerate([(1.5, 0.25, 0.125), (0.5, 0.75, 1.0), (2.0, 0.0, 3.0)]):
            logger["l2"].value = l2
            logger["cd"].value = cd
            logger.print_progress(-1, b + 1, loss)
        logger.clear()
        logger.print_progress(3, 1, 0.25, precision="{:.3f}")
        texts.append(out.getvalue())
        mod.StatsLogger.reset()
    assert texts[0] == texts[1]
    assert "loss: 1.33333 - l2: 0.33333 - cd: 1.37500" in texts[1]
    assert isinstance(port_logger.WandB.instance(), port_logger.StatsLogger)
    port_logger.StatsLogger.reset()


def test_pad_batch_matches_jax():
    batch = {"a": np.arange(6.0).reshape(3, 2), "index": np.array([0, 1, 2])}
    for target in (3, 5):
        (pj, mj), (pp, mp) = jax_padding.pad_batch(batch, target), port_padding.pad_batch(batch, target)
        _assert_items_equal(pj, pp)
        assert np.array_equal(mj, mp)
    with pytest.raises(ValueError, match="exceeds"):
        port_padding.pad_batch(batch, 2)


def _fake_predict_np(points, inputs):
    """A deformation field of both packages' test: points moved by the
    mean conditioning row."""
    return 2.0 * points + inputs.mean(axis=1, keepdims=True)[..., 0:3]


@pytest.mark.parametrize("masks", [False, True])
def test_test_on_batch_matches_jax(rng, masks):
    """The per-batch evaluation: surface and bucket-padded vertex queries,
    the point mask passed through, the vertex loss (over
    ``verts_valid_mask`` where given), from a fake deformation field."""
    B, N, V = 2, 16, 50
    batch = {"surface_samples_inputs": rng.randn(B, N, 7).astype(np.float32),
             "verts_src": rng.randn(B, V, 3).astype(np.float32),
             "verts_tgt": rng.randn(B, V, 3).astype(np.float32)}
    if masks:
        batch["surface_valid_mask"] = np.ones((B, N), np.float32)
        batch["verts_valid_mask"] = (rng.rand(B, V) > 0.3).astype(np.float32)
    seen = {"jax": [], "port": []}

    def jax_predict(state, points, inputs, point_mask=None):
        seen["jax"].append((np.asarray(points).shape, point_mask is not None))
        return jnp.asarray(_fake_predict_np(np.asarray(points), np.asarray(inputs)))

    def port_predict(points, inputs, point_mask=None):
        seen["port"].append((np.asarray(points).shape, point_mask is not None))
        return torch.as_tensor(_fake_predict_np(np.asarray(points), np.asarray(inputs)))

    lj, bj = jax_steps.test_on_batch({"predict": jax_predict}, None, dict(batch), bucket=32)
    lp, bp = port_steps.test_on_batch({"predict": port_predict}, dict(batch), bucket=32)
    assert seen["port"] == seen["jax"] == [((B, N, 3), masks), ((B, 64, 3), masks)]
    np.testing.assert_allclose(lp, lj, rtol=1e-6)
    for key in ("surface_samples_tgt_pred", "verts_tgt_pred"):
        np.testing.assert_array_equal(bp[key], bj[key])
    assert bp["verts_tgt_pred"].shape == (B, V, 3)
    # a bare callable, and no loss without compute_loss
    out = port_padding.predict_padded(lambda p, i: _fake_predict_np(p, i), batch["verts_src"],
                                      batch["surface_samples_inputs"], bucket=32)
    np.testing.assert_array_equal(out, bp["verts_tgt_pred"])
    assert port_steps.test_on_batch({"predict": port_predict}, dict(batch),
                                    compute_loss=False)[0] == 0.0
