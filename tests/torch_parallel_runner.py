"""One rank of the multi-process runs of ``tests/test_torch_parallel.py``
and ``tests/test_torch_card.py``, and :func:`launch`, which starts them.

    python -m tests.torch_parallel_runner parts OUTDIR
    python -m tests.torch_parallel_runner cli OUTDIR TRAIN_ARGS...
    python -m tests.torch_parallel_runner card OUTDIR DTYPE [TRAIN_ARGS...]

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

``card`` is a rank sharing the one card with the others: it joins a gloo
group on ``cuda:0`` and takes two stage-2 steps of the shipped model in
DTYPE through ``make_steps(group=...)`` on its rows (``float32`` through
the kernels, ``float64`` through the plain path, :class:`plain_on_card`).
It writes to ``OUTDIR/card<r>.pt`` the launches of each step, its state
after each and, of the first, the canonicalised points and their
gradients (``FlowArbitrary.canonicalize``'s outputs).  Given TRAIN_ARGS it
then runs ``cli`` on the same group (``--device cuda:0`` among them).
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds for one launch of the ranks on the CPU


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


class plain_on_card:
    """Within this context the model's attention and FPS take their plain
    PyTorch versions on CUDA tensors too, so that a model in float64 runs
    on the card.  The neighbours are selected in float32 from the float32
    coordinates, as K1 selects them, and FPS picks in float32 as K3 does,
    so every selection is the card's."""

    def __enter__(self):
        from nsdp_tpu_torch.nn import blocks
        from nsdp_tpu_torch.ops import attention, fps
        from nsdp_tpu_torch.ops.knn import mask_penalty, select

        def attend(xyz_q, kv_xyz, q_feats, K_a, V_a, *weights, k, k_glob=None, v_glob=None,
                   kv_mask=None):
            k = min(k, kv_xyz.shape[1])
            penalty = None if kv_mask is None else mask_penalty(kv_mask.float())
            idx = select(xyz_q.float(), kv_xyz.float(), k, penalty)[0]
            return attention.fused_vector_attention_plain(
                xyz_q, kv_xyz, q_feats, K_a, V_a, *weights, k, k_glob, v_glob, idx=idx)

        self.saved = blocks.fused_vector_attention, blocks.furthest_point_sample
        blocks.fused_vector_attention = attend
        blocks.furthest_point_sample = fps.furthest_point_sample_plain
        return self

    def __exit__(self, *exc):
        from nsdp_tpu_torch.nn import blocks

        blocks.fused_vector_attention, blocks.furthest_point_sample = self.saved


def card(outdir, dtype, argv):
    from nsdp_tpu_torch import parallel
    from nsdp_tpu_torch.models import build_model, init_random
    from nsdp_tpu_torch.ops import attention, fps
    from nsdp_tpu_torch.training import make_steps, optimizer_factory
    from nsdp_tpu_torch.utils.config import load_config
    from tests.test_torch_graphs import train_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    dtype = getattr(torch, dtype)
    cfg = load_config(os.path.join(REPO, "configs", "deform4d", "arbitrary.yaml"))
    model = init_random(build_model(cfg, device="cuda"), 2, out_scale=0.01).to(dtype)
    schedule, opt = optimizer_factory(cfg["training"], model.parameters())
    steps = make_steps(model, "arbitrary", opt, device="cuda", group=dist.group.WORLD)
    counters = lambda: (attention.fused_vector_attention.launches,
                        attention.fused_vector_attention_backward.launches,
                        fps.furthest_point_sample.launches)
    canonicalize, record, cot = model.canonicalize, {}, [None, None]

    def recording(*args, **kwargs):
        out = canonicalize(*args, **kwargs)
        for i, t in enumerate(out):
            t.register_hook(lambda g, i=i: cot.__setitem__(i, g.detach().cpu()))
        record["cano"] = [t.detach().cpu() for t in out]
        return out

    rng, out = np.random.RandomState(7), {"launches": [], "losses": []}
    with plain_on_card() if dtype == torch.float64 else contextlib.nullcontext():
        for i in range(2):
            batch = train_batch(rng, 8, 5000, 5000)
            model.canonicalize = recording if i == 0 else canonicalize
            before = counters()
            out["losses"].append(steps["train_step"](parallel.local_slice(batch, 8),
                                                     schedule.get_learning_rate(0)))
            out["launches"].append(tuple(a - b for a, b in zip(counters(), before)))
            out[f"step{i + 1}"] = {k: v.cpu() for k, v in _state(model, opt).items()}
    out["step1"].update(cano=record["cano"], cot=cot)
    torch.save(out, _rank_file(outdir, "card") + ".pt")
    if argv:
        cli(outdir, argv)
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_once(role, outdir, world, args, timeout):
    port = _free_port()
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        if world > 1:
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env.update(OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_runner", role, str(outdir), *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [""] * world

    def drain(r):
        outs[r] = procs[r].stdout.read()
        procs[r].wait()

    threads = [threading.Thread(target=drain, args=(r,), daemon=True) for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        if any(t.is_alive() for t in threads):
            raise subprocess.TimeoutExpired(procs[0].args, timeout)
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r} failed (rc={p.returncode}):\n{outs[r][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def launch(role, outdir, world, args=(), timeout=TIMEOUT):
    """``world`` ranks of this runner (one: no distributed environment) to
    completion, each within ``timeout`` seconds -> their outputs.  The
    pipes are drained concurrently and every process is killed on any
    failure path: a rank left in a collective would wait out gloo's
    timeout.  Once more on a fresh port if the store's port was taken
    between its probe and its bind."""
    try:
        return _launch_once(role, outdir, world, args, timeout)
    except AssertionError as e:
        if "address already in use" not in str(e).lower():
            raise
        return _launch_once(role, outdir, world, args, timeout)


if __name__ == "__main__":
    role, outdir, *rest = sys.argv[1:]
    {"parts": lambda: parts(outdir), "cli": lambda: cli(outdir, rest),
     "card": lambda: card(outdir, rest[0], rest[1:])}[role]()
