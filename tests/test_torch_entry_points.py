"""The port's evaluation entry points == the JAX package's on the CPU.

``nsdp_tpu_torch.test.main`` / ``nsdp_tpu_torch.run.main`` (``--device
cpu``, the plain PyTorch path) against ``test.py`` / ``run.py`` (the flax
path, ``--matmul_precision highest``) on the synthetic fixture, both sides
holding the weights of ONE model file that the port's
``training/checkpoints.py`` writes from ``init_random`` weights (the JAX side
reads it with ``load_model_variables``, which converts torch files), and the
global ``np.random`` reseeded before each side.  Every file both write must
exist on both sides; the deformed vertices read back from the written meshes
and point clouds agree within the tolerance of
``tests/test_torch_predict.py``, every float of the ``<motion_split>.txt``
progress lines within that of ``tests/test_entry_points.py`` between the
JAX package's own routes, and every other file is byte for byte the same.
"""

import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import nsdp_tpu_torch.run as port_run
import nsdp_tpu_torch.test as port_test
from nsdp_tpu.utils.logger import StatsLogger as JaxStatsLogger
from nsdp_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    generate_userhandle_dataset,
    synthetic_config,
)
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.training import optimizer_factory, save_checkpoints
from nsdp_tpu_torch.utils import meshio

REPO = Path(__file__).resolve().parents[1]
VERTS_TOL = dict(rtol=1e-3, atol=2e-4)  # tests/test_torch_predict.py:57
LINES_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_entry_points.py:195
HEAD_HANDLE = {
    "cliptail": False, "head": True, "tail": False,
    "frontleftfoot": False, "frontrightfoot": False,
    "behindleftfoot": False, "behindrightfoot": False,
    "xtrans": -0.15, "ytrans": -0.2, "ztrans": -0.2,
}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    return generate_synthetic_dataset(
        str(root), n_identities=1, n_motions_per_identity=1, n_frames=3,
        n_surface=200, n_space=200,
    )


def _jax_cli(name):
    """The JAX package's ``<name>.py`` at the repository's root, loaded by
    path (the standard library has a ``test`` package of its own)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _weight_file(cfg, directory, seed=3):
    """A model file of the port's checkpointing, with seeded random weights
    whose deformed positions are O(1) (``out_scale``): at init_random's
    O(100) the elementwise tolerance would hold float32 rounding to ~1e-6
    of the output's scale."""
    model = init_random(build_model(cfg, device="cpu"), seed, out_scale=0.01)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    save_checkpoints(0, model, opt, str(directory))
    return str(directory / "model_00000")


def _run_both(cfg, tmp_path, jax_cli, port_cli):
    """Run the JAX and the port's entry point on ``cfg`` -> their experiment
    directories."""
    cfg["test"]["weight_file"] = _weight_file(cfg, tmp_path)
    dirs = {}
    for side, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu", "--num_threads",
                                                 str(torch.get_num_threads())])):
        cfg["experiment"]["out_dir"] = str(tmp_path / side)
        path = str(tmp_path / f"{side}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        JaxStatsLogger.reset()
        # the datasets draw from the global np.random stream
        np.random.seed(7)
        cli.main([path, "--matmul_precision", "highest", *extra])
        dirs[side] = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])
    return dirs["jax"], dirs["port"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _progress_floats(path):
    """Every float on the progress lines (loss and the running means); the
    epoch/batch ints carry no decimal point and don't match."""
    with open(path) as f:
        lines = [line for line in f.read().splitlines() if "loss:" in line]
    return [[float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", line)] for line in lines]


def _compare_outputs(jax_dir, port_dir):
    """-> the number of deformed files compared within VERTS_TOL."""
    files = _files(jax_dir)
    assert files == _files(port_dir)
    n_deformed = 0
    for rel in files:
        a, b = os.path.join(jax_dir, rel), os.path.join(port_dir, rel)
        if rel.endswith(".txt"):
            ja, po = _progress_floats(a), _progress_floats(b)
            assert len(ja) == len(po) > 0
            for x, y in zip(ja, po):
                assert len(x) == len(y)
                np.testing.assert_allclose(y, x, **LINES_TOL)
        elif os.sep + "deformed" + os.sep in rel:
            np.testing.assert_allclose(meshio.load_mesh(b)[0], meshio.load_mesh(a)[0],
                                       **VERTS_TOL)
            n_deformed += 1
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    return n_deformed


@pytest.mark.parametrize("padded_partial", [False, True])
def test_test_entry_point_matches_jax(fixture, tmp_path, padded_partial):
    """``python -m nsdp_tpu_torch.test`` == ``test.py``; the second case on
    padded partial shapes at batch 2, as
    ``tests/test_entry_points.py::test_test_cli_padded_partial_runs_fused_path``."""
    cfg = synthetic_config(fixture)
    if padded_partial:
        cfg["data"]["partial_shape_ratio"] = 0.6
        cfg["data"]["pad_partial_shapes"] = True
        cfg["test"]["batch_size"] = 2
    jax_dir, port_dir = _run_both(cfg, tmp_path, _jax_cli("test"), port_test)
    # two pairs: a deformed mesh and a deformed point cloud each
    assert _compare_outputs(jax_dir, port_dir) == 4
    assert os.path.exists(os.path.join(port_dir, "test_unseen_motions.txt"))


def test_run_entry_point_matches_jax(tmp_path):
    """``python -m nsdp_tpu_torch.run`` == ``run.py`` on the TOSCA-style
    fixture of ``tests/test_entry_points.py::test_run_cli_userhandle``."""
    fx = generate_userhandle_dataset(str(tmp_path / "data"))
    cfg = synthetic_config(fx, model_type="arbitrary", arbitrary=True)
    cfg["data"]["type"] = "tosca"
    cfg["data"]["mesh_file"] = "model_normalized.obj"
    cfg["data"]["userhandle"] = dict(HEAD_HANDLE)
    cfg["test"]["iden_split"] = "identity_unseen"
    cfg["test"]["motion_split"] = "test_unseen_identities"
    cfg["test"]["generate_pointcloud"] = False
    jax_dir, port_dir = _run_both(cfg, tmp_path, _jax_cli("run"), port_run)
    assert _compare_outputs(jax_dir, port_dir) == 1
    assert os.listdir(port_dir) == ["drag_head_x-0.15y-0.20z-0.20_ratio0.10"]


@pytest.mark.parametrize("cli", [port_test, port_run])
def test_entry_points_raise_without_a_card(cli, fixture, tmp_path, monkeypatch):
    """``--device cuda`` (the default) with no card raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = synthetic_config(fixture)
    cfg["experiment"]["out_dir"] = str(tmp_path / "out")
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    for argv in ([path], [path, "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert not os.path.exists(tmp_path / "out")
