"""The repository's headline benchmark on the card: the port's counterpart of
``bench.py``.

    python -m nsdp_tpu_torch.bench               # one CUDA card; prints one JSON line
    python -m nsdp_tpu_torch.bench --metric qps  # one metric, in this process

It measures what ``bench.py`` measures, through the port's own entry points,
and prints the same JSON line (``bench.py:351-408``: the same keys, the same
rounding), plus ``flops_per_eval``, ``peak_flops``, ``device``,
``power_limit_w`` and ``graphs``:

* ``value``: query points per second of the flagship arbitrary-pose model
  (``FLAGSHIP_CONFIG``: the full-width ``FlowArbitrary``, both encoders and
  three decodings an evaluation) at batch 1, 5000 surface points and
  Q = 65,536 query points, through ``FlowArbitrary.predict``;
  ``vs_baseline`` is it over the repository's floor of 1M query points/s
  (``BASELINE.md``); ``mfu`` the model's float32 operations an evaluation
  (``flops_per_eval``) over the evaluation's time and the card's float32
  rate outside the tensor cores (``PEAK_FLOPS``: the model is float32 and
  products in TF32 are off);
* ``train_step_ms_stage1_b16`` / ``_stage1_bwd_b16`` / ``_stage2_b8``: a
  train step (``training.steps.make_steps``, Adam at 5e-4) of the
  ``forward`` and ``backward`` nets at batch 16 and of the ``arbitrary``
  composition at batch 8, N = Q = 5000; ``*_bf16``: the same with
  ``compute_dtype: bfloat16``;
* ``drag_ms``: one drag of an edit session, ``FlowArbitrary.deform`` (the
  forward half) at Q = 65,536 after one ``canonicalize``.

Protocol (``slope_time``): each metric runs a chain of k dependent calls on
the card -- each call is fed the previous one's output, or the previous
step's parameters -- that ends in one scalar fetched to the host, and the
time of a call is the slope between a 1-call and a (1 + K)-call chain.  The
fixed costs of a chain, its synchronising fetch above all, cancel.  Every
chain runs through captured programs (``graphs.Graphs``, one per metric):
the evaluation and the drag are one program each, replayed k times; the
train step is ``make_steps``' captured step.  Each metric is measured
``NSDP_BENCH_REPEATS`` (default 3) times; the line carries the median and
``*_spread``, (max - min) / median.

Each metric runs in a process of its own (``--metric NAME``), so that each
model's memory pool goes with its process and a hang costs at most
``NSDP_BENCH_METRIC_TIMEOUT`` seconds (default 600).  ``flops_per_eval``
counts the matrix products of one evaluation of the plain PyTorch path on
the CPU (``torch.utils.flop_counter``; the kernels on the card are opaque to
the counter), in a process of its own too.  The kernels are built once,
before the first metric (``ops/_build.py``'s cache).  Nothing is retried: a
metric that fails prints ``null`` and its error as ``<key>_error``, and the
process exits 1 after the line.  Without a card the process exits non-zero
before anything is timed.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

# the flagship arbitrary-pose model (``__graft_entry__.py:6-25``)
FLAGSHIP_CONFIG = {
    "model": {
        "type": "arbitrary",
        "use_normals": False,
        "encoder": "pointransformer",
        "encoder_kwargs": dict(
            npoints_per_layer=[5000, 500, 100],
            nneighbor=16,
            nneighbor_reduced=10,
            nfinal_transformers=3,
            d_transformer=256,
            d_reduced=120,
            full_SA=True,
        ),
        "decoder": "crossatten",
        "decoder_kwargs": dict(
            dim_inp=256, dim=200, nneigh=7, hidden_dim=128, out_dim=3
        ),
    },
}

QPS_Q = 65536  # query points per headline evaluation
# H100 SXM data sheet: float32 outside the tensor cores (700 W part)
PEAK_FLOPS = 67e12
BASELINE_QPS = 1e6  # the repository's floor (BASELINE.md)
LR = 5e-4
# the seeded weights' decoder output scale: the deformed points stay at the
# unit scale of the queries (a trained model's), so every call of a chain
# gets queries like the first's (without it they drift to O(1e4))
OUT_SCALE = 0.01
# bench.py's keys with their rounding (bench.py:396-404)
SECONDARY = (
    ("train_step_ms_stage1_b16", 1),
    ("train_step_ms_stage1_bwd_b16", 1),
    ("train_step_ms_stage2_b8", 1),
    ("train_step_ms_stage1_b16_bf16", 1),
    ("train_step_ms_stage1_bwd_b16_bf16", 1),
    ("train_step_ms_stage2_b8_bf16", 1),
    ("drag_ms", 2),
)


def _example_batch(B, N, Q, seed=0):
    """The benchmark's inputs (``__graft_entry__.py:107-117``, the same
    draws in the same order): surface (B, N, 7), space source and target
    (B, Q, 3)."""
    rng = np.random.RandomState(seed)
    surf_src = rng.randn(B, N, 3).astype(np.float32)
    surf_tgt = rng.randn(B, N, 3).astype(np.float32)
    mask = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
    inputs = np.concatenate([surf_src, surf_tgt * mask, mask], -1)
    return {
        "surface_samples_inputs": inputs,
        "space_samples_src": rng.randn(B, Q, 3).astype(np.float32),
        "space_samples_tgt": rng.randn(B, Q, 3).astype(np.float32),
    }


def slope_time(run, K, n_rep=5, reset=None):
    """Seconds a call from the slope of the chain protocol.

    ``run(k)`` runs a chain of k dependent calls on the device and ends in a
    scalar fetched to the host, which waits for the whole chain.  Each chain
    length is run once to warm (and capture) and then timed ``n_rep`` times;
    the slope between the medians at 1 and 1 + K calls cancels what a chain
    costs once (the final fetch, the launch of the first call).  ``reset()``,
    if given, runs before every chain, outside the timed window (a train
    chain puts its start state back there).
    """
    def sync(k):
        ts = []
        for i in range(n_rep + 1):
            if reset is not None:
                reset()
            t0 = time.perf_counter()
            run(k)
            if i:  # the first run warms
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t1 = sync(1)
    t2 = sync(1 + K)
    return max((t2 - t1) / K, 1e-9)


def _setup(config, seed, device, out_scale=1.0):
    """(torch, the model of ``config`` on ``device`` with seeded weights)."""
    import torch

    from nsdp_tpu_torch import resolve_device
    from nsdp_tpu_torch.models import build_model, init_random

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(config, device=device)
    init_random(model, seed, out_scale=out_scale)
    return torch, model, device


def _programs(device, graphs):
    """``call(name, fn, *args)``: ``fn(*args)`` through one
    :class:`~nsdp_tpu_torch.graphs.Graphs` program (captured on the card; on
    the CPU the static-buffer contract), or eagerly with ``graphs=False``.
    None: captured on the card."""
    from nsdp_tpu_torch.graphs import Graphs

    if graphs is None:
        graphs = device.type == "cuda"
    return Graphs(device) if graphs else (lambda name, fn, *args: fn(*args))


def _fetch(x) -> float:
    """The chain's one synchronising fetch: the sum of ``x``; a non-finite
    sum raises."""
    value = float(x.sum().item())
    if not np.isfinite(value):
        raise FloatingPointError("the chain's output is not finite")
    return value


def qps_measure(config=FLAGSHIP_CONFIG, N=5000, Q=QPS_Q, K=20, n_rep=7, device=None,
                graphs=None, seed=0):
    """The headline (``bench.py:96-132``): a chain of
    ``FlowArbitrary.predict`` calls, each on the previous call's output,
    through one program.  Returns ``measure() -> query points/s``."""
    torch, model, device = _setup(config, seed, device, OUT_SCALE)
    batch = _example_batch(B=1, N=N, Q=Q)
    inputs = torch.as_tensor(batch["surface_samples_inputs"], device=device)
    space = torch.as_tensor(batch["space_samples_src"], device=device)
    call = _programs(device, graphs)

    def evaluate(points, surface_samples_inputs):
        with torch.no_grad():
            return model.predict(points, surface_samples_inputs)

    def run(k):
        x = space
        for _ in range(k):
            x = call("predict", evaluate, x, inputs)
        return _fetch(x)

    return lambda: Q / slope_time(run, K, n_rep=n_rep)


def drag_measure(config=FLAGSHIP_CONFIG, N=5000, Q=QPS_Q, K=20, n_rep=7, device=None,
                 graphs=None, seed=0):
    """One drag (``bench.py:190-229``): ``FlowArbitrary.canonicalize`` once,
    then a chain of ``FlowArbitrary.deform`` calls through one program, each
    on the previous call's output.  Returns ``measure() -> ms``."""
    torch, model, device = _setup(config, seed, device, OUT_SCALE)
    batch = _example_batch(B=1, N=N, Q=Q)
    inputs = torch.as_tensor(batch["surface_samples_inputs"], device=device)
    space = torch.as_tensor(batch["space_samples_src"], device=device)
    surf_src, surf_tgt, mask = inputs[..., 0:3], inputs[..., 3:6], inputs[..., 6:7]
    with torch.no_grad():
        space_cano, surf_cano = model.canonicalize(space, surf_src)
    call = _programs(device, graphs)

    def drag(points, surf_cano, surf_tgt, mask):
        with torch.no_grad():
            return model.deform(points, surf_cano, surf_tgt, mask)

    def run(k):
        x = space_cano
        for _ in range(k):
            x = call("drag", drag, x, surf_cano, surf_tgt, mask)
        return _fetch(x)

    return lambda: slope_time(run, K, n_rep=n_rep) * 1e3


def train_chain(config=FLAGSHIP_CONFIG, model_type="forward", compute_dtype="float32", B=16,
                N=5000, Q=5000, device=None, graphs=None, seed=0):
    """A chain of train steps (``scripts/bench_train.py:24-74``) that every
    run starts from the same state.

    ``make_steps``' train step (captured by default on the card: its first
    call runs eagerly, its second captures; both run here, before anything
    is timed) with Adam at 5e-4 on one device-resident batch.  Then the
    parameters, every buffer (BatchNorm's running statistics) and the
    optimizer's state are snapshotted; ``reset()`` copies them back in place
    (the captured step reads those tensors at their addresses) and waits for
    the card.  ``run(k)`` takes k steps and fetches the first parameter's
    sum and the last loss in one read; a non-finite loss raises.  Returns a
    namespace of ``run``, ``reset`` and ``model``.
    """
    cfg = {"model": dict(config["model"], type=model_type, compute_dtype=compute_dtype)}
    torch, model, device = _setup(cfg, seed, device)

    from nsdp_tpu_torch.training import make_steps, optimizer_factory

    _, opt = optimizer_factory({"optimizer": "Adam", "lr": LR}, model.parameters())
    steps = make_steps(model, model_type, opt, device=device, graphs=graphs)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in _example_batch(B=B, N=N, Q=Q).items()}
    step = steps["train_step"]
    for _ in range(2):  # the eager first step, then the capture
        step(batch, LR)
    state = ([*model.parameters(), *model.buffers()]
             + [t for s in opt.state.values() for t in s.values() if torch.is_tensor(t)])
    saved = [t.detach().clone() for t in state]
    first = next(model.parameters())

    def reset():
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(k):
        for _ in range(k):
            loss = step(batch, LR, fetch=False)
        value, last = torch.stack([first.detach().sum(), loss.float()]).tolist()
        if not np.isfinite(last):
            raise FloatingPointError(f"the last loss of the chain is {last}")
        return value

    return SimpleNamespace(run=run, reset=reset, model=model)


def train_measure(config=FLAGSHIP_CONFIG, model_type="forward", compute_dtype="float32", B=16,
                  N=5000, Q=5000, K=8, n_rep=5, device=None, graphs=None, seed=0):
    """A train step's time (``bench.py:232-265``).  Returns
    ``measure() -> ms``."""
    chain = train_chain(config, model_type, compute_dtype, B, N, Q, device, graphs, seed)
    return lambda: slope_time(chain.run, K, n_rep=n_rep, reset=chain.reset) * 1e3


def flops_per_eval(config=FLAGSHIP_CONFIG, N=5000, Q=QPS_Q, seed=0) -> float:
    """Model FLOPs of one headline evaluation: the matrix products of the
    plain PyTorch path on the CPU (``torch.utils.flop_counter``), at the
    benchmark's shapes (the kernels on the card are opaque to the counter,
    and the wrappers take no ``meta`` tensor).  The count depends on the
    shapes alone, not on the weights or the points; the elementwise work,
    which XLA's cost analysis of the JAX package's flax path also counts,
    is left out (about 1%)."""
    torch, model, _ = _setup(config, seed, "cpu")
    from torch.utils.flop_counter import FlopCounterMode

    batch = _example_batch(B=1, N=N, Q=Q, seed=seed)
    points = torch.from_numpy(batch["space_samples_src"])
    inputs = torch.from_numpy(batch["surface_samples_inputs"])
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.predict(points, inputs)
    return float(counter.get_total_flops())


# the train metrics: name -> (model type, compute dtype, batch)
TRAIN_METRICS = {
    "train_step_ms_stage1_b16": ("forward", "float32", 16),
    "train_step_ms_stage1_bwd_b16": ("backward", "float32", 16),
    "train_step_ms_stage2_b8": ("arbitrary", "float32", 8),
    "train_step_ms_stage1_b16_bf16": ("forward", "bfloat16", 16),
    "train_step_ms_stage1_bwd_b16_bf16": ("backward", "bfloat16", 16),
    "train_step_ms_stage2_b8_bf16": ("arbitrary", "bfloat16", 8),
}


def _train(model_type, compute_dtype, B):
    return lambda: train_measure(model_type=model_type, compute_dtype=compute_dtype, B=B)


# metric name -> setup() -> measure() (setup builds and captures once; the
# repeats reuse it)
METRICS = {"qps": qps_measure, **{name: _train(*spec) for name, spec in TRAIN_METRICS.items()},
           "drag_ms": drag_measure}


def launches():
    """Kernel launches so far by the wrappers' counters (an eager call and
    a capture count; a replay does not)."""
    from nsdp_tpu_torch.ops import attention, fps, gather, knn

    return {"K1": attention.fused_vector_attention.launches,
            "K2": attention.fused_vector_attention_backward.launches,
            "K3": fps.furthest_point_sample.launches, "K4": knn.knn.launches,
            "gather": gather.gather_rows.launches}


def run_metric(name):
    """Child mode: one metric, measured ``NSDP_BENCH_REPEATS`` times on one
    setup; prints one JSON line with the median, the spread, the values
    and the kernels' launches (``bench.py:268-287``)."""
    if name == "flops_per_eval":
        print(json.dumps({"metric": name, "value": flops_per_eval()}))
        return
    repeats = max(int(os.environ.get("NSDP_BENCH_REPEATS", "3")), 1)
    measure = METRICS[name]()
    values = [float(measure()) for _ in range(repeats)]
    med = float(np.median(values))
    print(json.dumps({
        "metric": name,
        "value": med,
        "spread": (max(values) - min(values)) / med if med else None,
        "values": values,
        "launches": launches(),
    }))


def measure_in_subprocess(name, timeout):
    """One metric in a fresh process (``python -m nsdp_tpu_torch.bench
    --metric NAME``) -> its JSON object; raises ``RuntimeError`` with the
    end of its output if it fails, prints no line or outlasts ``timeout``
    seconds (then it is killed)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        proc = subprocess.run([sys.executable, "-m", "nsdp_tpu_torch.bench", "--metric", name],
                              capture_output=True, text=True, timeout=timeout, cwd=root)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"timeout after {timeout} s") from None
    if proc.returncode == 0:
        for line in reversed(proc.stdout.strip().splitlines()):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and obj.get("metric") == name:
                return obj
    tail = (proc.stderr or proc.stdout or "").strip()[-500:]
    raise RuntimeError(f"exit {proc.returncode}: {tail}")


def setup_card():
    """-> (the card's name, its power limit in W).  Raises without a card;
    builds every kernel (once: the metrics' processes load them)."""
    import torch

    from nsdp_tpu_torch import resolve_device
    from nsdp_tpu_torch.ops import _build

    resolve_device("cuda")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build()
    return torch.cuda.get_device_name(0), float(line.rsplit(",", 1)[1].split()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's headline benchmark (one CUDA card)")
    ap.add_argument("--metric", choices=sorted(METRICS) + ["flops_per_eval"],
                    help="child mode: measure one metric and print its line")
    args = ap.parse_args(argv)
    if args.metric:
        run_metric(args.metric)
        return 0

    try:
        device, power_limit = setup_card()
    except RuntimeError as e:  # no card, or a kernel that does not build
        print(f"bench: {e}", file=sys.stderr)
        return 2
    timeout = int(os.environ.get("NSDP_BENCH_METRIC_TIMEOUT", "600"))
    result = {
        "metric": "deformation_field_query_throughput",
        "value": None,
        "unit": "query_points/sec/chip",
        "vs_baseline": None,
        "spread": None,
        "mfu": None,
    }
    for key, _ in SECONDARY:
        result[key] = None
        result[key + "_spread"] = None
    errors = {}

    def measured(name, key):
        try:
            return measure_in_subprocess(name, timeout)
        except RuntimeError as e:
            errors[key + "_error"] = repr(e)[:500]
            return None

    qobj = measured("qps", "value")
    fobj = measured("flops_per_eval", "mfu")
    if qobj is not None:
        qps = qobj["value"]
        result["value"] = round(qps, 1)
        result["vs_baseline"] = round(qps / BASELINE_QPS, 4)
        if qobj.get("spread") is not None:
            result["spread"] = round(qobj["spread"], 4)
    if fobj is not None:
        result["flops_per_eval"] = fobj["value"]
        if qobj is not None:
            # mfu = flops/eval / time/eval / peak = flops/eval x qps / (Q x peak)
            result["mfu"] = round(fobj["value"] * qobj["value"] / (QPS_Q * PEAK_FLOPS), 4)
        else:
            errors["mfu_error"] = "no query throughput to divide by"
    for key, digits in SECONDARY:
        obj = measured(key, key)
        if obj is not None:
            result[key] = round(obj["value"], digits)
            if obj.get("spread") is not None:
                result[key + "_spread"] = round(obj["spread"], 4)
    result.update(errors)
    result.update(peak_flops=PEAK_FLOPS, device=device, power_limit_w=power_limit, graphs=True)
    print(json.dumps(result), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
