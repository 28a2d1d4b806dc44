"""Train a deformation network: the port's counterpart of ``train.py``.

    python -m nsdp_tpu_torch.train CONFIG [--num_workers N] [--num_threads N]
        [--seed S] [--continue_from_epoch E] [--best_val_loss L]
        [--with_wandb_logger] [--matmul_precision default|high|highest]
        [--profile_dir DIR] [--device cuda|cpu]

The loop is ``train.py``'s (reference ``train.py``): per epoch its learning
rate, the shuffled training batches (``drop_last``), the parameter and
gradient norms for wandb every ``logger.log_frequency`` epochs, a
checkpoint every ``training.save_frequency`` epochs, and every
``validation.frequency`` epochs after the first a validation over every
sample (the last batch padded and masked), with a ``modelbest_*`` file on
a better loss.  Files go where ``train.py`` writes them: ``params.json``,
``stats.txt`` (the progress lines, running means), ``model_*``, ``opt_*``
and ``modelbest_*`` in ``<out_dir>/<name>/``; an existing run there is
resumed (best model first, then the latest checkpoint).

The host stays ahead of the card: batches go up from pinned memory without
waiting for the device, the step's loss is read one step late (a step is
queued before the previous one's loss is read), and checkpoints are written
on a background thread.  On one card each train step is a captured CUDA
graph (``make_steps``' ``graphs``, the counterpart of ``train.py``'s
compiled step): its first step runs eagerly, the second captures, the rest
replay, each batch copied from its upload into the graph's static inputs;
a last batch of another size captures a graph of its own.  Validation and
the watch norms run as captured graphs too (from a signature's second
call, in the step's memory pool), and so does every rank's step under NCCL, its all-reduces inside the graph;
under gloo the steps stay eager.  The report names the programs and their
replays.  The model runs on ``cuda`` (every kNN attention,
its backward and every FPS a hand-written kernel) unless ``--device cpu``
asks for the plain PyTorch path.  Weights start from
``models.init_random(model, seed)``, then ``training.weight_file`` or the
stage-1 files ``training.weight_forward_file`` / ``weight_backward_file``
of an 'arbitrary' model.

One process, one device -- or data-parallel, one process per device under
``torch.distributed`` (``train.py:81-83,114-139,192-200,239,255-293``):

    torchrun --nproc_per_node N -m nsdp_tpu_torch.train CONFIG [--device cpu]

Each rank runs on ``cuda:LOCAL_RANK`` (NCCL) or the CPU (gloo), assembles
its own rows of every training batch, and the step equals the
single-process step on the whole batch (``make_steps(group=...)``).  The
weights are broadcast from rank 0 once loaded; validation batches are
padded to a multiple of the world size and sliced per rank; every rank
runs the watch norms and validation (they are collectives), and only rank
0 writes files (``params.json``, ``stats.txt``, checkpoints, the wandb
log, the profile).  A process group that exists before ``main`` is used
as it is.
"""

import argparse
import contextlib
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from nsdp_tpu_torch.data import DataLoader, dataset_dict
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.parallel import (
    broadcast_module,
    check_train_batch,
    initialize_distributed,
    is_main_process,
    local_slice,
    process_batch_slice,
    rank,
    world_size,
)
from nsdp_tpu_torch.test import MATMUL_PRECISION, report_programs
from nsdp_tpu_torch.training import (
    load_best_checkpoints,
    load_checkpoints,
    load_subnetwork,
    make_steps,
    optimizer_factory,
    read_state_dict,
)
from nsdp_tpu_torch.training.async_ckpt import AsyncCheckpointer
from nsdp_tpu_torch.training.optim import print_num_parameters
from nsdp_tpu_torch.utils.config import load_config, save_experiment_params
from nsdp_tpu_torch.utils.logger import StatsLogger, WandB
from nsdp_tpu_torch.utils.padding import pad_batch
from nsdp_tpu_torch.utils.profiling import StepTimer, trace_steps

# the batch keys the step functions read
STEP_KEYS = ("surface_samples_inputs", "space_samples_src", "space_samples_tgt",
             "surface_valid_mask")
# the parts of the loop whose wall times main() returns
PARTS = ("data", "step", "fetch", "watch", "validation", "checkpoint")


def parse_args(argv):
    parser = argparse.ArgumentParser(description="Train a deformation network")
    parser.add_argument("config_file", help="experiment configuration YAML")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="data loader threads (0: load in the main thread)")
    parser.add_argument("--num_threads", type=int, default=4,
                        help="PyTorch's CPU threads (torch.set_num_threads)")
    parser.add_argument("--seed", type=int, default=27,
                        help="seed of the weights, the shuffle and the datasets")
    parser.add_argument("--continue_from_epoch", type=int, default=0)
    parser.add_argument("--best_val_loss", type=float, default=9999999999999)
    parser.add_argument("--with_wandb_logger", action="store_true")
    parser.add_argument("--matmul_precision", default="default",
                        choices=sorted(MATMUL_PRECISION))
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the first epoch to this directory")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; cuda:LOCAL_RANK under several ranks) or cpu, "
                        "the plain PyTorch path")
    return parser.parse_args(argv)


def upload(array, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; to a card from pinned memory,
    queued on the current stream without waiting for it (a copy from
    pageable memory waits for every queued step)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: upload(batch[k], device) for k in STEP_KEYS if k in batch}


def make_dataset(config, section: str):
    cfg = config[section]
    return dataset_dict[config["data"]["type"]](
        config,
        iden_split=cfg["iden_split"],
        motion_split=cfg["motion_split"],
        load_mesh=cfg["load_mesh"],
        num_sampled_pairs=cfg["num_sampled_pairs"],
    )


def load_weights(model, config) -> None:
    """``training.weight_forward_file`` / ``weight_backward_file`` into an
    'arbitrary' model's branches, then ``training.weight_file`` into the
    whole model (``train.py:171-182``)."""
    tcfg = config["training"]
    if config["model"]["type"] == "arbitrary":
        for key, branch, what in (("weight_forward_file", "model_deform", "forward"),
                                  ("weight_backward_file", "model_canonicalize", "backward")):
            if tcfg.get(key):
                print(f"Loading weight {what} file from {tcfg[key]}")
                load_subnetwork(model, tcfg[key], branch)
    if tcfg.get("weight_file"):
        print(f"Loading weight file from {tcfg['weight_file']}")
        model.load_state_dict(read_state_dict(tcfg["weight_file"]), strict=True)


def report_times(times: Dict[str, List[float]]) -> None:
    """One line: the wall time of each part of the loop, in all and per call."""
    split = ", ".join(f"{k} {sum(v):.4f} s ({len(v)}x)" for k, v in times.items())
    print(f"Wall time by part of the loop: {split}")


def main(argv) -> Dict[str, List[float]]:
    """Train; returns the wall times (s) of the parts of the loop: per
    train step ``data`` (waiting on the loader, and the upload), ``step``
    (the host's time to queue the step) and ``fetch`` (reading the loss one
    step late); per call ``watch`` (the norms for wandb), ``validation``
    (the whole pass) and ``checkpoint`` (the snapshots on this thread, and
    the last wait for the writer)."""
    args = parse_args(argv)
    # before the first CUDA tensor: the process group, the rank's device
    device = initialize_distributed(args.device)
    n_proc, main_proc = world_size(), is_main_process()
    group = dist.group.WORLD if n_proc > 1 else None
    torch.set_num_threads(args.num_threads)
    torch.set_float32_matmul_precision(MATMUL_PRECISION[args.matmul_precision])
    np.random.seed(args.seed)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else device
    if n_proc > 1:
        where = f"{where} (rank {rank()} of {n_proc} processes)"
    print("Running on", where)

    config = load_config(args.config_file)
    experiment_name = config["experiment"]["name"]
    experiment_directory = os.path.join(config["experiment"]["out_dir"], experiment_name)
    os.makedirs(experiment_directory, exist_ok=True)
    if main_proc:
        save_experiment_params(args, experiment_name, experiment_directory, config)
        print(f"Save experiment statistics in {experiment_directory}")

    train_dataset = make_dataset(config, "training")
    validation_dataset = make_dataset(config, "validation")
    batch_size = config["training"].get("batch_size", 16)
    check_train_batch(batch_size)
    # every rank draws the same shuffled order (the same seed) and assembles
    # only its own rows of each batch
    train_loader = DataLoader(train_dataset, batch_size=batch_size, shuffle=True,
                              drop_last=True, num_workers=args.num_workers, seed=args.seed,
                              batch_slice=process_batch_slice(batch_size) if n_proc > 1 else None)
    print(f"Loaded {len(train_dataset)} training deformation pairs")
    # every validation sample counts (the reference's drop_last=False); the
    # last partial batch is padded and masked below, to a multiple of the
    # world size, and every rank takes its slice
    val_batch_size = config["validation"].get("batch_size", 1)
    val_target = -(-val_batch_size // n_proc) * n_proc
    val_loader = DataLoader(validation_dataset, batch_size=val_batch_size, shuffle=False,
                            drop_last=False, num_workers=args.num_workers)
    print(f"Loaded {len(validation_dataset)} validation deformation pairs")
    # train.py draws items 0 and 1 as its model's example batch; drawing
    # them here as well keeps the datasets' random stream, and so every
    # later item, the same as train.py's for the same seed
    for i in range(min(2, len(train_dataset))):
        train_dataset[i]

    model_type = config["model"]["type"]
    model = init_random(build_model(config, device=device), args.seed)
    schedule, optimizer = optimizer_factory(config["training"], model.parameters())
    steps = make_steps(model, model_type, optimizer,
                       nan_guard=config["training"].get("nan_guard", False), device=device,
                       group=group)
    print_num_parameters(model, model_type)
    load_weights(model, config)

    # resume: the best model, then the latest checkpoint (train.py:185-186)
    epoch, loss = load_best_checkpoints(model, experiment_directory)
    if epoch is not None:
        args.continue_from_epoch, args.best_val_loss = epoch, loss
    epoch = load_checkpoints(model, optimizer, experiment_directory)
    if epoch is not None:
        args.continue_from_epoch = epoch
    if group is not None:  # no rank starts apart
        broadcast_module(model)
    print(f"Training on {device}, validation batches padded to {val_target}")

    logger_cfg = config.get("logger", {})
    wandb_watch = bool(args.with_wandb_logger and logger_cfg.get("watch", True))
    watch_every = logger_cfg.get("log_frequency", 10)
    StatsLogger.reset()  # a logger of this run's own
    if args.with_wandb_logger and main_proc:
        # watch defaults on, as the reference's wandb.watch(model)
        WandB.instance().init(config, project=logger_cfg.get("project", "NSDP"),
                              name=experiment_name, watch=wandb_watch,
                              log_frequency=watch_every)
    logger = StatsLogger.instance()

    epochs = config["training"].get("epochs", 1000)
    save_every = config["training"].get("save_frequency", 20)
    val_every = config["validation"].get("frequency", 10)
    timer = StepTimer()
    checkpointer = AsyncCheckpointer()
    times = {k: [] for k in PARTS}

    def report(epoch, b, loss):
        timer.tick()
        logger["steps_per_sec"].value = timer.steps_per_sec
        t0 = time.perf_counter()
        loss = float(loss)
        times["fetch"].append(time.perf_counter() - t0)
        logger.print_progress(epoch + 1, b + 1, loss)

    stats_path = os.path.join(experiment_directory, "stats.txt")
    with (open(stats_path, "w") if main_proc else contextlib.nullcontext()) as stats:
        if stats is not None:
            logger.add_output_file(stats)
        for epoch in range(args.continue_from_epoch, epochs):
            lr = schedule.get_learning_rate(epoch)
            first = epoch == args.continue_from_epoch
            with trace_steps(args.profile_dir if first and main_proc else None):
                # step b's loss is read after step b + 1 is queued, so the
                # device never waits for the host (train.py:233-251)
                pending = None
                t0 = time.perf_counter()
                for b, batch in enumerate(train_loader):
                    batch = to_device(batch, device)
                    t1 = time.perf_counter()
                    loss = steps["train_step"](batch, lr, fetch=False)
                    times["data"].append(t1 - t0)
                    times["step"].append(time.perf_counter() - t1)
                    if pending is not None:
                        report(epoch, *pending)
                    # the step's own copy of its loss: a captured step's
                    # static loss is overwritten by the next replay
                    pending = (b, loss)
                    t0 = time.perf_counter()
                if pending is not None:
                    report(epoch, *pending)

            if wandb_watch and pending is not None and epoch % max(1, watch_every) == 0:
                # the norms on the epoch's last batch (wandb.watch's log_freq);
                # a collective: every rank takes them, rank 0 logs them
                t0 = time.perf_counter()
                norms = steps["watch_stats"](batch)
                if main_proc:
                    logger.log_watch(*norms)
                times["watch"].append(time.perf_counter() - t0)

            if epoch % save_every == 0 and main_proc:
                t0 = time.perf_counter()
                checkpointer.save(epoch, model, optimizer, experiment_directory)
                times["checkpoint"].append(time.perf_counter() - t0)
            logger.clear()

            if epoch % val_every == 0 and epoch > 0:
                t0 = time.perf_counter()
                print("====> Validation Epoch ====>")
                for b, batch in enumerate(val_loader):
                    batch, sample_mask = pad_batch(batch, val_target)
                    if n_proc > 1:
                        batch = local_slice(batch, val_target)
                        sample_mask = sample_mask[process_batch_slice(val_target)]
                    loss = steps["validate_step_masked"](to_device(batch, device),
                                                         upload(sample_mask, device))
                    logger.print_progress(-1, b + 1, loss)
                val_loss = logger.loss
                times["validation"].append(time.perf_counter() - t0)
                if val_loss < args.best_val_loss:
                    if main_proc:
                        t0 = time.perf_counter()
                        checkpointer.save_best(epoch, model, experiment_directory, val_loss)
                        times["checkpoint"].append(time.perf_counter() - t0)
                    args.best_val_loss = val_loss
                logger.clear()
                print("====> Validation Epoch ====>")
        t0 = time.perf_counter()
        checkpointer.wait()
        times["checkpoint"].append(time.perf_counter() - t0)
    report_times(times)
    report_programs(steps, ("train_step", "validate_step"))
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
