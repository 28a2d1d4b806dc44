"""Data-parallel training over several processes and query-split serving
(``nsdp_tpu_torch.parallel``) on the CPU.

Ranks are real processes (``tests/torch_parallel_runner.py``) on gloo,
launched with torchrun's environment on a free port, each launch within
the runner's ``TIMEOUT`` and every process killed on any failure path (as
``tests/test_multihost_2proc.py:42-93`` launches its pair).  Held:

* synced ``BatchNorm`` of 2 ranks against ``nsdp_tpu``'s
  ``_TorchExactBatchNorm`` under ``bn_sync_axis`` in a ``shard_map`` over 2
  of the 8 virtual CPU devices: output, running statistics and the
  gradients of a scalar loss, with and without a mask (unequal valid
  counts per rank), within ``BN_TOL`` (float32, sums in another order);
* a stage-1 (masked) and a stage-2 train step of the tiny configs with 2
  ranks against the port's single-process step on the whole batch, in
  float64 within ``F64_TOL`` -- a missing cross-rank gradient term errs by
  1e-3 or more -- and in float32 within ``F32_TOL``; the ranks' states
  bit for bit equal;
* the same two ranks on the captured contract (``make_steps(graphs=True)``):
  train steps, validations and ``watch_stats`` bit for bit the eager ones;
* ``nan_guard`` with a non-finite target on one rank's rows: both skip;
* the validation steps over padded, per-rank-sliced batches;
* the loader's ``batch_slice`` against ``nsdp_tpu.data.loader``, bit for bit;
* the helpers with and without a process group;
* ``python -m nsdp_tpu_torch.train --device cpu`` on 2 ranks against 1;
* ``DeformationService(devices=("cpu", "cpu"))`` against one device.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nsdp_tpu.data import loader as jax_loader
from nsdp_tpu.data import dataset_dict as jax_datasets
from nsdp_tpu.nn.blocks import _TorchExactBatchNorm, bn_sync_axis
from nsdp_tpu.parallel.mesh import make_mesh, shard_map
from nsdp_tpu_torch import parallel
from nsdp_tpu_torch.data import DataLoader, dataset_dict
from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_config
from nsdp_tpu_torch.serving import DeformationService
from nsdp_tpu_torch.utils.padding import pad_batch
from tests.test_torch_train_cli import LINES_TOL, _progress, _weight_file
from tests.torch_parallel_runner import CAPTURED_RUNS, _model, _state
from tests.torch_parallel_runner import launch as _launch

BN_TOL = dict(rtol=1e-5, atol=1e-5)
# float64: a step's parts agree to ~1e-13; the gradient terms that a
# non-differentiable all-reduce drops are 1e-3 or more of a gradient
F64_TOL = dict(rtol=1e-9, atol=1e-11)
# float32: the ranks sum the batch statistics and the gradients in another
# order than one process (relative L2 error per tensor, floor for the
# gradients that vanish analytically: a fraction of the largest gradient)
F32_TOL = dict(rel=1e-4, floor=1e-6)
LR = 1e-3


# ---------------------------------------------------------------- inputs


def _bn_cases():
    rng = np.random.RandomState(0)
    shape = (4, 16, 8)  # 2 rows a rank
    base = dict(x=rng.randn(*shape).astype(np.float32) * 2 + 0.5,
                cot=rng.randn(*shape).astype(np.float32),
                weight=(1 + 0.1 * rng.randn(8)).astype(np.float32),
                bias=(0.1 * rng.randn(8)).astype(np.float32),
                running_mean=(0.1 * rng.randn(8)).astype(np.float32),
                running_var=(0.5 + rng.rand(8)).astype(np.float32))
    mask = np.zeros(shape[:2], np.float32)
    for row, valid in enumerate((16, 11, 4, 1)):  # 27 valid on rank 0, 5 on rank 1
        mask[row, :valid] = 1.0
    return {"plain": base, "masked": dict(base, mask=mask)}


def _config(model_type):
    return synthetic_config({"dataset_dir": "", "split_dir": ""}, model_type=model_type,
                            arbitrary=model_type == "arbitrary")


def _batch(seed, B=4, N=128, Q=64, partial=False):
    """A training batch; ``partial``: padded partial shapes (a valid prefix
    of each cloud, padded rows at the origin), unequal per rank."""
    rng = np.random.RandomState(seed)
    src = rng.randn(B, N, 3).astype(np.float32)
    handle = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
    tgt = (src + 0.1 * rng.randn(B, N, 3).astype(np.float32)) * handle
    batch = {"surface_samples_inputs": np.concatenate([src, tgt, handle], -1),
             "space_samples_src": rng.randn(B, Q, 3).astype(np.float32),
             "space_samples_tgt": rng.randn(B, Q, 3).astype(np.float32)}
    if partial:
        mask = np.zeros((B, N), np.float32)
        for row, valid in enumerate((N, 100, 90, 70)):
            mask[row, :valid] = 1.0
        batch["surface_samples_inputs"] *= mask[..., None]
        batch["surface_valid_mask"] = mask
    return batch


STEP_RUNS = {
    f"{stage}_{dtype}": dict(config=_config(model), batch=_batch(seed, partial=partial),
                             dtype=dtype, lr=LR)
    for stage, model, seed, partial in (("stage1", "forward", 1, True),
                                        ("stage2", "arbitrary", 2, False))
    for dtype in ("float64", "float32")
}


def _nan_batch():
    batch = _batch(3)
    batch["space_samples_tgt"][3, 5] = np.nan  # rank 1's rows only
    return batch


def _validation():
    batch = _batch(4)
    real = {k: v[:3] for k, v in batch.items()}  # 3 samples padded to 4: 2 a rank
    padded, sample_mask = pad_batch(real, 4)
    return dict(config=_config("forward"), batch=padded, sample_mask=sample_mask)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results of ``torch_parallel_runner parts``."""
    outdir = tmp_path_factory.mktemp("torch_parallel")
    torch.save({"bn": _bn_cases(), "steps": STEP_RUNS,
                "nan_guard": dict(config=_config("forward"), batch=_nan_batch(), lr=LR),
                "validation": _validation()}, outdir / "inputs.pt")
    _launch("parts", outdir, 2)
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(2)]


# ---------------------------------------------------------------- (i)


def _jax_bn(case):
    """``_TorchExactBatchNorm`` under ``bn_sync_axis('data')`` in a
    ``shard_map`` over 2 devices, as ``nsdp_tpu/training/steps.py``'s
    sharded step runs it: the gradients of each shard's loss, the
    parameters' summed over the shards -> (y, dx, d params, statistics)."""
    mesh = make_mesh(jax.devices()[:2], data=2, query=1)
    bn = _TorchExactBatchNorm()
    params = {"scale": case["weight"], "bias": case["bias"]}
    stats = {"mean": case["running_mean"], "var": case["running_var"]}
    masked = "mask" in case

    def body(params, x, cot, *mask):
        def loss(params, x):
            with bn_sync_axis("data"):
                y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                                  use_running_average=False, mask=mask[0] if masked else None,
                                  mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, upd["batch_stats"])

        (_, (y, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, gx, jax.lax.psum(gp, "data"), new

    P = jax.sharding.PartitionSpec
    specs = (P(), P("data"), P("data")) + ((P("data"),) if masked else ())
    fn = shard_map(body, mesh=mesh, in_specs=specs, out_specs=(P("data"), P("data"), P(), P()))
    args = (case["x"], case["cot"]) + ((case["mask"],) if masked else ())
    return jax.device_get(jax.jit(fn)(params, *args))


@pytest.mark.parametrize("case", ["plain", "masked"])
def test_synced_batchnorm_matches_bn_sync_axis(ranks, case):
    y, dx, dparams, new = _jax_bn(_bn_cases()[case])
    got = [r["bn"][case] for r in ranks]
    cat = lambda k: torch.cat([g[k] for g in got]).numpy()
    np.testing.assert_allclose(cat("y"), y, **BN_TOL)
    np.testing.assert_allclose(cat("dx"), dx, **BN_TOL)
    for g in got:
        np.testing.assert_allclose(g["dweight"].numpy(), dparams["scale"], **BN_TOL)
        np.testing.assert_allclose(g["dbias"].numpy(), dparams["bias"], **BN_TOL)
        np.testing.assert_allclose(g["running_mean"].numpy(), new["mean"], **BN_TOL)
        np.testing.assert_allclose(g["running_var"].numpy(), new["var"], **BN_TOL)


# ---------------------------------------------------------------- (ii)


def _single_process_step(run):
    """The port's step on the whole batch, in this process, no group."""
    model, opt, steps = _model(run["config"], getattr(torch, run["dtype"]))
    loss = steps["train_step"](run["batch"], run["lr"])
    return dict(loss=loss, **_state(model, opt))


@pytest.mark.parametrize("name", sorted(STEP_RUNS))
def test_two_rank_step_equals_single_process_step(ranks, name):
    run = STEP_RUNS[name]
    want = _single_process_step(run)
    got = dict(ranks[0]["steps"][name])
    other = dict(ranks[1]["steps"][name])
    assert sorted(got) == sorted(other) == sorted(want)
    rank_loss = got.pop("loss")
    assert rank_loss == other.pop("loss")
    for k in got:  # the ranks hold the same state bit for bit
        assert torch.equal(got[k], other[k]), k
    grads = [k for k in want if k.startswith("grad/")]
    assert len(grads) == sum(1 for k in want if k.startswith("param/"))
    scale = max(float(want[k].abs().max()) for k in grads)
    loss = want.pop("loss")
    if run["dtype"] == "float64":
        np.testing.assert_allclose(rank_loss, loss, rtol=1e-12)
        for k in want:
            atol = F64_TOL["atol"] * (scale if k.startswith(("grad/", "opt/")) else 1.0)
            np.testing.assert_allclose(got[k].double().numpy(), want[k].double().numpy(),
                                       rtol=F64_TOL["rtol"], atol=atol, err_msg=k)
    else:
        np.testing.assert_allclose(rank_loss, loss, rtol=1e-6)
        for k in want:
            if k.startswith(("grad/", "buffer/")) and "num_batches" not in k:
                err = float((got[k] - want[k]).norm())
                limit = F32_TOL["rel"] * float(want[k].norm()) + F32_TOL["floor"] * scale
                assert err <= limit, f"{k}: error {err:.3g} beyond {limit:.3g}"


@pytest.mark.parametrize("name", CAPTURED_RUNS)
def test_two_ranks_on_the_captured_contract_equal_eager(ranks, name):
    """Two gloo ranks with ``graphs=True`` (the captured contract on the
    CPU, the collectives inside each program): three train steps (the
    eager first step, the capture, a replay), both validations and
    ``watch_stats`` twice, bit for bit the eager two-rank run on each rank."""
    for r in ranks:
        captured, eager = dict(r["captured"][name][True]), dict(r["captured"][name][False])
        assert captured.pop("captured") and not eager.pop("captured")
        assert captured["losses"] == eager["losses"] and np.isfinite(eager["losses"]).all()
        for (val, masked, watch), (val_e, masked_e, watch_e) in zip(captured["evaluation"],
                                                                    eager["evaluation"]):
            assert (val, masked) == (val_e, masked_e)
            for (top, leaves), (top_e, leaves_e) in zip(watch, watch_e):
                assert top == top_e
                np.testing.assert_array_equal(leaves, leaves_e)
        assert sorted(captured) == sorted(eager)
        for k, v in eager.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(captured[k], v), k
    assert ranks[0]["captured"][name][True]["losses"] == ranks[1]["captured"][name][True]["losses"]


# ---------------------------------------------------------------- (iii), (iv)


def test_nan_guard_skips_on_every_rank(ranks):
    """The target is non-finite on rank 1's rows only; the averaged loss
    decides, so both ranks skip and keep parameters, optimizer state and
    running statistics bit for bit."""
    got = [r["nan_guard"] for r in ranks]
    assert [g["rows_finite"] for g in got] == [True, False]
    for g in got:
        assert not np.isfinite(g["loss"]) and g["unchanged"]


def test_validation_over_padded_sliced_batches(ranks):
    run = _validation()
    _, _, steps = _model(run["config"], torch.float32)
    masked = steps["validate_step_masked"](run["batch"], run["sample_mask"])
    mean = steps["validate_step"](run["batch"])
    assert run["sample_mask"].tolist() == [1, 1, 1, 0]
    for r in ranks:
        np.testing.assert_allclose(r["validation"]["masked"], masked, rtol=1e-6)
        np.testing.assert_allclose(r["validation"]["mean"], mean, rtol=1e-6)
    assert ranks[0]["validation"] == ranks[1]["validation"]


# ---------------------------------------------------------------- (v)


class _Indexed:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"x": np.full((3, 2), i, np.float32), "index": i}

    @staticmethod
    def collate_fn(samples):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in samples[0]}


@pytest.fixture(scope="module")
def data_fixture(tmp_path_factory):
    return generate_synthetic_dataset(str(tmp_path_factory.mktemp("parallel_data")),
                                      n_identities=1, n_motions_per_identity=2, n_frames=4,
                                      n_surface=200, n_space=200)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("sl", [slice(0, 2), slice(2, 4)])
def test_loader_batch_slice_matches_jax(data_fixture, workers, sl):
    kw = dict(batch_size=4, shuffle=True, drop_last=True, num_workers=workers, seed=5,
              batch_slice=sl)
    got = list(DataLoader(_Indexed(), **kw))
    want = list(jax_loader.DataLoader(_Indexed(), collate_fn=_Indexed.collate_fn, **kw))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        assert len(a["index"]) == 2
    # the real dataset, synchronously (its random draws are then in order)
    cfg = synthetic_config(data_fixture)
    batches = []
    for registry, make in ((jax_datasets, jax_loader.DataLoader), (dataset_dict, DataLoader)):
        np.random.seed(3)
        ds = registry["deform4d"](cfg, "identity_seen", "train_seen")
        batches.append(list(make(ds, batch_size=4, shuffle=True, drop_last=True, seed=1,
                                 batch_slice=sl)))
    assert len(batches[0]) == len(batches[1]) > 0
    for a, b in zip(*batches):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(_Indexed(), batch_size=4, batch_slice=sl)


# ---------------------------------------------------------------- (vi)


def test_helpers_without_a_process_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (parallel.world_size(), parallel.rank(), parallel.local_rank()) == (1, 0, 0)
    assert parallel.is_main_process()
    assert parallel.process_batch_slice(5) == slice(0, 5)
    batch = {"a": np.arange(6).reshape(3, 2), "s": np.float32(2)}
    assert parallel.local_slice(batch, 3) is not batch
    assert np.array_equal(parallel.local_slice(batch, 3)["a"], batch["a"])
    parallel.check_train_batch(7)  # any batch with one process


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"WORLD_SIZE": "two"},
                                 {"OMPI_COMM_WORLD_SIZE": "4"}])
def test_initialize_distributed_raises_on_a_malformed_environment(monkeypatch, env):
    """A launch of several processes whose rendezvous is incomplete fails
    loudly instead of running as one process."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        parallel.initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_helpers_on_two_ranks(ranks):
    for r, out in enumerate(ranks):
        h = out["helpers"]
        assert (h["device"], h["rank"], h["world"], h["main"]) == ("cpu", r, 2, r == 0)
        assert h["slice"] == slice(4 * r, 4 * r + 4)
        assert np.array_equal(h["local"]["a"], np.arange(4 * r, 4 * r + 4))
        assert h["local"]["s"] == 3
        assert h["errors"] == {
            "check_train_batch": "multi-process training (2 processes, 2 devices) requires "
            "batch_size divisible by the device count; got batch_size=7. Pick a multiple of 2.",
            "process_batch_slice": "global batch 5 not divisible by 2 processes"}


# ---------------------------------------------------------------- (vii)


def test_train_cli_on_two_ranks_equals_one(tmp_path):
    """Two ranks of ``python -m nsdp_tpu_torch.train --device cpu`` for 2
    epochs (batch 2: one row a rank; 5 validation pairs, the last batch
    padded) against one, from one weight file with O(1) outputs (as
    ``tests/test_torch_train_cli.py`` starts): every ``stats.txt`` float
    but the wall-clock ``steps_per_sec`` within ``LINES_TOL``, the same
    files, each written once, by rank 0 only."""
    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=1, n_frames=5, n_surface=200,
                                    n_space=200)
    weights = _weight_file(synthetic_config(fx), tmp_path / "weights")
    dirs, writes = {}, {}
    for world in (1, 2):
        cfg = synthetic_config(fx)
        cfg["training"]["weight_file"] = weights
        cfg["experiment"]["out_dir"] = str(tmp_path / f"out{world}")
        path = tmp_path / f"cfg{world}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        outdir = tmp_path / f"ranks{world}"
        outdir.mkdir()
        _launch("cli", outdir, world, [str(path), "--device", "cpu", "--seed", "0",
                                       "--num_threads", "1", "--matmul_precision", "highest"])
        dirs[world] = tmp_path / f"out{world}" / cfg["experiment"]["name"]
        writes[world] = [json.loads((outdir / f"writes{r}.json").read_text())
                         for r in range(world)]
    assert writes[1] == [{"params": 1, "save": 2, "save_best": 1}]
    assert writes[2] == [writes[1][0], {"params": 0, "save": 0, "save_best": 0}]
    names = [sorted(os.listdir(dirs[w])) for w in (1, 2)]
    best = [[n for n in ns if n.startswith("modelbest_")] for ns in names]
    assert [len(b) for b in best] == [1, 1]
    assert [n for n in names[1] if n not in best[1]] == [n for n in names[0] if n not in best[0]]
    (e1, l1), (e2, l2) = [b[0][len("modelbest_"):].split("_") for b in best]
    assert e1 == e2
    np.testing.assert_allclose(float(l2), float(l1), **LINES_TOL)
    want, got = _progress(dirs[1] / "stats.txt"), _progress(dirs[2] / "stats.txt")
    assert len(want) == len(got) == 7  # 2 epochs of 2 steps, 3 validation batches
    for (we, wb, wv), (ge, gb, gv) in zip(want, got):
        assert (we, wb, sorted(wv)) == (ge, gb, sorted(gv))
        for k, v in wv.items():
            if k != "steps_per_sec":
                np.testing.assert_allclose(gv[k], v, **LINES_TOL, err_msg=f"{we}/{wb} {k}")


# ---------------------------------------------------------------- (viii)


def test_query_split_serving_matches_one_device():
    cfg = _config("arbitrary")
    one = DeformationService(cfg, device="cpu", seed=3, buckets=(301,))
    two = DeformationService(cfg, devices=("cpu", "cpu"), seed=3, buckets=(301,))
    assert [len(s.replicas) for s in (one, two)] == [1, 2]
    assert (one._bucket(300), two._bucket(300), two._bucket(700)) == (301, 302, 904)
    rng = np.random.RandomState(0)
    surf = rng.randn(128, 3).astype(np.float32)
    handle = (surf[:, 2] > 0.3).astype(np.float32)[:, None]
    inputs = np.concatenate([surf, (surf + 0.2) * handle, handle], -1)
    pm = np.ones(128, np.float32)
    pm[-20:] = 0.0
    tol = dict(rtol=1e-5, atol=1e-6)  # the same rows through products of fewer rows
    for q in (300, 700):
        pts = rng.randn(q, 3).astype(np.float32)
        for mask in (None, pm):
            inp = inputs if mask is None else inputs * mask[:, None]
            want = one.deform(pts, inp, point_mask=mask)
            got = two.deform(pts, inp, point_mask=mask)
            assert got.shape == want.shape == (q, 3)
            np.testing.assert_allclose(got, want, **tol)
        sessions = [s.edit_session(pts, surf) for s in (one, two)]
        for scale in (1.0, 0.5):
            want, got = [s.drag((surf + 0.2 * scale) * handle, handle) for s in sessions]
            assert got.shape == want.shape == (q, 3)
            np.testing.assert_allclose(got, want, **tol)
    with pytest.raises(ValueError, match="device or devices"):
        DeformationService(cfg, device="cpu", devices=("cpu",))
