"""One rank of ``tests/test_torch_parallel.py``'s multi-process runs.

    python -m tests.torch_parallel_runner parts OUTDIR
    python -m tests.torch_parallel_runner cli OUTDIR TRAIN_ARGS...

The launching test sets torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or none for one process.
Imports torch and the port only (no JAX), so that a rank starts quickly.

``parts`` joins the gloo group through ``initialize_distributed('cpu')``,
reads the inputs that the test wrote to ``OUTDIR/inputs.pt`` and writes
this rank's results to ``OUTDIR/rank<r>.pt``: synced BatchNorm (output,
running statistics, gradients), one train step of each model and dtype
through ``make_steps(group=...)``, ``nan_guard`` with a non-finite target
on rank 1's rows, the validation steps, three train steps, both
validations and ``watch_stats`` on the captured contract beside the eager
ones (``CAPTURED_RUNS``), and the per-rank helpers.

``cli`` runs ``nsdp_tpu_torch.train.main(TRAIN_ARGS)`` with every item of
the datasets drawn from a generator of its own index and the training pair
list held fixed (``_ItemSeeded``): the datasets draw their subsamples from
one stream in the order items are assembled, and reshuffle their pairs when
the last index is drawn, so a rank that assembles half of each batch would
otherwise see other items than one process assembling all of it.  It
writes ``OUTDIR/writes<r>.json``: how often this rank wrote the run's
files.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


# the step runs that ``parts`` also takes on the captured contract
# (``make_steps(graphs=True)`` on the CPU) beside the eager steps
CAPTURED_RUNS = ("stage1_float32", "stage2_float32")


def _rank_file(outdir, name):
    return os.path.join(outdir, f"{name}{dist.get_rank() if dist.is_initialized() else 0}")


def _bn_case(case, group):
    from nsdp_tpu_torch.nn.blocks import BatchNorm, bn_sync
    from nsdp_tpu_torch.parallel import local_slice

    rows = {k: case[k] for k in ("x", "cot", "mask") if k in case}
    local = {k: torch.from_numpy(v) for k, v in local_slice(rows, len(case["x"])).items()}
    bn = BatchNorm(case["x"].shape[-1], device="cpu")
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(case[name]))
    bn.train()
    x = local["x"].requires_grad_()
    with bn_sync(group):
        y = bn(x, local.get("mask"))
    (y * local["cot"]).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    for g in grads:  # each rank holds its rows' share of the parameters' gradient
        dist.all_reduce(g)
    return dict(y=y.detach(), dx=x.grad, dweight=grads[0], dbias=grads[1],
                running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone())


def _model(cfg, dtype, seed=0, **kw):
    from nsdp_tpu_torch.models import build_model, init_random
    from nsdp_tpu_torch.training import make_steps, optimizer_factory

    model = init_random(build_model(cfg, device="cpu"), seed, out_scale=0.01).to(dtype)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    return model, opt, make_steps(model, cfg["model"]["type"], opt, device="cpu", **kw)


def _state(model, opt):
    """Parameters, gradients, buffers and Adam moments, as host copies."""
    out = {f"param/{k}": v.detach().clone() for k, v in model.named_parameters()}
    out.update({f"grad/{k}": v.grad.clone() for k, v in model.named_parameters()
                if v.grad is not None})
    out.update({f"buffer/{k}": v.clone() for k, v in model.named_buffers()})
    for i, p in enumerate(model.parameters()):
        for k, v in opt.state.get(p, {}).items():
            out[f"opt/{i}/{k}"] = v.clone()
    return out


def parts(outdir):
    from nsdp_tpu_torch import parallel

    torch.set_num_threads(1)
    device = parallel.initialize_distributed("cpu")
    group = dist.group.WORLD
    inputs = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    out = {"bn": {name: _bn_case(case, group) for name, case in inputs["bn"].items()}}

    out["steps"] = {}
    for name, run in inputs["steps"].items():
        model, opt, steps = _model(run["config"], getattr(torch, run["dtype"]), group=group)
        local = parallel.local_slice(run["batch"], len(run["batch"]["space_samples_src"]))
        loss = steps["train_step"](local, run["lr"])
        out["steps"][name] = dict(loss=loss, **_state(model, opt))

    run = inputs["nan_guard"]
    model, opt, steps = _model(run["config"], torch.float32, nan_guard=True, group=group)
    before = _state(model, opt)
    local = parallel.local_slice(run["batch"], len(run["batch"]["space_samples_src"]))
    loss = steps["train_step"](local, run["lr"])
    after = _state(model, opt)
    out["nan_guard"] = dict(loss=loss, rows_finite=bool(np.isfinite(local["space_samples_tgt"]).all()),
                            unchanged=sorted(before) == sorted(after)
                            and all(torch.equal(before[k], after[k]) for k in before))

    run = inputs["validation"]
    _, _, steps = _model(run["config"], torch.float32, group=group)
    batch, target = run["batch"], len(run["sample_mask"])
    out["validation"] = dict(
        masked=steps["validate_step_masked"](parallel.local_slice(batch, target),
                                             run["sample_mask"][parallel.process_batch_slice(target)]),
        mean=steps["validate_step"](parallel.local_slice(batch, target)))

    out["captured"] = {}
    for name in CAPTURED_RUNS:
        run, results = inputs["steps"][name], {}
        rows = len(run["batch"]["space_samples_src"])
        local = parallel.local_slice(run["batch"], rows)
        sample_mask = np.array([1.0] * (rows - 1) + [0.0], np.float32)
        sample_mask = sample_mask[parallel.process_batch_slice(rows)]
        for graphs in (True, False):
            model, opt, steps = _model(run["config"], torch.float32, group=group, graphs=graphs)
            losses = [steps["train_step"](local, run["lr"]) for _ in range(3)]
            evaluation = [(steps["validate_step"](local),
                           steps["validate_step_masked"](local, sample_mask),
                           steps["watch_stats"](local)) for _ in range(2)]
            results[graphs] = dict(losses=losses, evaluation=evaluation, **_state(model, opt),
                                   captured=steps["train_step"].graphs is not None
                                   and steps["watch_stats"].graphs is not None)
        out["captured"][name] = results

    errors = {}
    for what, call in (("check_train_batch", lambda: parallel.check_train_batch(7)),
                       ("process_batch_slice", lambda: parallel.process_batch_slice(5))):
        try:
            call()
        except ValueError as e:
            errors[what] = str(e)
    parallel.check_train_batch(8)
    out["helpers"] = dict(device=str(device), rank=parallel.rank(), world=parallel.world_size(),
                          main=parallel.is_main_process(), slice=parallel.process_batch_slice(8),
                          local=parallel.local_slice({"a": np.arange(8), "s": np.float32(3)}, 8),
                          errors=errors)
    torch.save(out, _rank_file(outdir, "rank") + ".pt")
    dist.destroy_process_group()


class _ItemSeeded:
    """A dataset whose item ``i`` is drawn from ``default_rng(i)`` and
    whose pair list never reshuffles."""

    def __init__(self, ds):
        ds.is_train = False  # no reshuffle when the last index is drawn
        self.ds, self.collate_fn = ds, ds.collate_fn

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, index):
        self.ds.rng = np.random.default_rng(index)
        return self.ds[index]


def cli(outdir, argv):
    import nsdp_tpu_torch.train as port_train
    from nsdp_tpu_torch.training.async_ckpt import AsyncCheckpointer

    writes = {"params": 0, "save": 0, "save_best": 0}

    def counted(what, fn):
        def call(*args, **kwargs):
            writes[what] += 1
            return fn(*args, **kwargs)
        return call

    make_dataset = port_train.make_dataset
    port_train.make_dataset = lambda config, section: _ItemSeeded(make_dataset(config, section))
    port_train.save_experiment_params = counted("params", port_train.save_experiment_params)
    AsyncCheckpointer.save = counted("save", AsyncCheckpointer.save)
    AsyncCheckpointer.save_best = counted("save_best", AsyncCheckpointer.save_best)
    port_train.main(argv)
    with open(_rank_file(outdir, "writes") + ".json", "w") as f:
        json.dump(writes, f)


if __name__ == "__main__":
    role, outdir, *rest = sys.argv[1:]
    parts(outdir) if role == "parts" else cli(outdir, rest)
