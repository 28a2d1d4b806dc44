"""The port's DeformationService / EditSession == nsdp_tpu's on the CPU.

Both services hold the same weights (the JAX service's own, carried over
with ``from_jax_variables``) and serve the same numpy requests.
"""

import numpy as np
import pytest
import torch
import yaml

from nsdp_tpu.serving import DeformationService as JaxService
from nsdp_tpu_torch import resolve_device
from nsdp_tpu_torch.models import build_deformation_network, build_model
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.training import optimizer_factory, save_checkpoints
from nsdp_tpu_torch.utils.config import load_config
from nsdp_tpu_torch.utils.convert import from_jax_variables
from nsdp_tpu_torch.utils.padding import next_bucket, pad_queries
from tests.test_fast_predict import CFG

TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def services():
    cfg = {"model": dict(CFG["model"]), "training": {"optimizer": "Adam", "lr": 1e-3}}
    jax_svc = JaxService(cfg, buckets=(64,), use_fused=False)
    state = from_jax_variables(jax_svc.state.params, jax_svc.state.batch_stats)
    return jax_svc, DeformationService(cfg, state_dict=state, buckets=(64,), device="cpu")


def _request(rng, n=32, q=50):
    surf = rng.randn(n, 3).astype(np.float32)
    handle = (rng.rand(n, 1) > 0.5).astype(np.float32)
    tgt = rng.randn(n, 3).astype(np.float32) * handle
    return rng.randn(q, 3).astype(np.float32), surf, tgt, handle


def test_service_deform_matches_jax(services, rng):
    jax_svc, svc = services
    pts, surf, tgt, handle = _request(rng)
    inputs = np.concatenate([surf, tgt, handle], -1)
    got = svc.deform(pts, inputs)
    assert got.shape == (50, 3)
    np.testing.assert_allclose(got, jax_svc.deform(pts, inputs), **TOL)
    # batched and above the largest bucket (padded to a multiple of it)
    big = rng.randn(2, 100, 3).astype(np.float32)
    inputs_b = np.stack([inputs, inputs])
    np.testing.assert_allclose(svc.deform(big, inputs_b), jax_svc.deform(big, inputs_b), **TOL)


def test_service_masked_deform_matches_jax(services, rng):
    jax_svc, svc = services
    pts, surf, tgt, handle = _request(rng)
    pm = np.ones(32, np.float32)
    pm[-8:] = 0.0
    inputs = np.concatenate([surf, tgt, handle], -1) * pm[:, None]
    np.testing.assert_allclose(
        svc.deform(pts, inputs, point_mask=pm),
        jax_svc.deform(pts, inputs, point_mask=pm), **TOL,
    )


def test_edit_session_drag_matches_jax(services, rng):
    jax_svc, svc = services
    pts, surf, tgt, handle = _request(rng)
    session, jax_session = svc.edit_session(pts, surf), jax_svc.edit_session(pts, surf)
    for scale in (1.0, 0.5):  # two drags reuse one canonicalisation
        dragged = session.drag(tgt * scale, handle)
        np.testing.assert_allclose(dragged, jax_session.drag(tgt * scale, handle), **TOL)
        full = svc.deform(pts, np.concatenate([surf, tgt * scale, handle], -1))
        np.testing.assert_allclose(dragged, full, rtol=1e-5, atol=1e-6)


def test_warmup_runs_every_serving_entry(services, rng, monkeypatch):
    """warmup drives the plain, masked and edit-session paths at every
    bucket, and leaves the service answering as before."""
    jax_svc, svc = services
    calls = []

    def record(name):
        orig = getattr(svc, name)

        def wrapped(points, surface, point_mask=None):
            calls.append((name, len(points), point_mask is not None))
            return orig(points, surface, point_mask)

        monkeypatch.setattr(svc, name, wrapped)

    record("deform")
    record("edit_session")
    svc.warmup(32)
    assert sorted(calls) == [("deform", 64, False), ("deform", 64, True),
                             ("edit_session", 64, False), ("edit_session", 64, True)]
    pts, surf, tgt, handle = _request(rng)
    inputs = np.concatenate([surf, tgt, handle], -1)
    np.testing.assert_allclose(svc.deform(pts, inputs), jax_svc.deform(pts, inputs), **TOL)


def test_buckets_and_config(services):
    _, svc = services
    assert [svc._bucket(q) for q in (1, 64, 65, 200)] == [64, 64, 128, 256]
    assert next_bucket(5000) == 8192 and next_bucket(10, 64) == 64
    padded, q = pad_queries(np.ones((1, 5, 3), np.float32), 8)
    assert q == 5 and padded.shape == (1, 8, 3) and not padded[0, 5:].any()
    cfg = load_config("configs/deform4d/arbitrary.yaml")
    assert cfg["model"]["decoder_kwargs"]["dim"] == 200
    assert cfg["data"]["pad_partial_shapes"] is False  # default filled
    with pytest.raises(ValueError, match="arbitrary"):
        DeformationService({"model": dict(CFG["model"], type="forward")},
                           device="cpu").edit_session(np.zeros((4, 3)), np.zeros((8, 3)))


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, an entry point asked for nothing raises instead of
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeformationService({"model": dict(CFG["model"])})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model({"model": dict(CFG["model"])})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_deformation_network({"model": dict(CFG["model"])})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _config_file(tmp_path, weight_file):
    cfg = {"experiment": {"out_dir": str(tmp_path)}, "data": {}, "model": dict(CFG["model"]),
           "training": {"optimizer": "Adam", "lr": 1e-3}}
    cfg["model"]["encoder_kwargs"] = dict(cfg["model"]["encoder_kwargs"])
    cfg["model"]["decoder_kwargs"] = dict(cfg["model"]["decoder_kwargs"])
    if weight_file is not None:
        cfg["test"] = {"weight_file": str(weight_file)}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_from_config_loads_the_weight_file(tmp_path, rng):
    """``test.weight_file``, a model file the port's own checkpointing
    wrote, is what ``from_config`` serves."""
    trained = DeformationService({"model": dict(CFG["model"])}, device="cpu", seed=5)
    _, opt = optimizer_factory({"optimizer": "Adam", "lr": 1e-3}, trained.model.parameters())
    save_checkpoints(3, trained.model, opt, str(tmp_path))
    svc = DeformationService.from_config(
        str(_config_file(tmp_path, tmp_path / "model_00003")), buckets=(64,), device="cpu")
    for key, value in trained.model.state_dict().items():
        assert torch.equal(svc.model.state_dict()[key], value), key
    pts, surf, tgt, handle = _request(rng)
    inputs = np.concatenate([surf, tgt, handle], -1)
    np.testing.assert_array_equal(svc.deform(pts, inputs), trained.deform(pts, inputs))


def test_from_config_weight_file_missing_none_or_doubled(tmp_path):
    """A named file that is missing raises; ``weight_file=None`` serves the
    seeded random weights; weights given twice raise."""
    path = _config_file(tmp_path, tmp_path / "missing.pt")
    with pytest.raises(FileNotFoundError):
        DeformationService.from_config(str(path), device="cpu")
    seeded = DeformationService.from_config(str(path), device="cpu", weight_file=None, seed=4)
    ref = DeformationService({"model": dict(CFG["model"])}, device="cpu", seed=4)
    for key, value in ref.model.state_dict().items():
        assert torch.equal(seeded.model.state_dict()[key], value), key
    no_file = DeformationService.from_config(str(_config_file(tmp_path, None)), device="cpu", seed=4)
    assert all(torch.equal(no_file.model.state_dict()[k], v)
               for k, v in ref.model.state_dict().items())
    with pytest.raises(ValueError, match="not both"):
        DeformationService({"model": dict(CFG["model"])}, device="cpu",
                           state_dict=ref.model.state_dict(), weight_file=str(path))
