"""Evaluate a deformation network: the port's counterpart of ``test.py``.

    python -m nsdp_tpu_torch.test CONFIG [--num_workers N] [--num_threads N]
        [--matmul_precision default|high|highest] [--device cuda|cpu]

Per test batch, deform the surface samples and the full-resolution vertices
(``training.steps.test_on_batch``); per pair, compute l2 / fnc / cd (values
above 1.0 are dropped from the aggregate, as in the reference) and export
meshes and point clouds.  Files go where ``test.py`` writes them:
``<out_dir>/<name>/<motion_split>.txt`` (the progress lines, running means)
and ``<out_dir>/<name>/<motion_split>/<mesh_folder|pointcloud_folder>/``.

The model runs on ``cuda`` (every kNN attention and FPS a hand-written
kernel) unless ``--device cpu`` asks for the plain PyTorch path.  On the
card each evaluation is ``make_steps``' ``predict``: a signature's first
call runs eagerly, its second captures a CUDA graph, later ones replay it,
and the outputs are the eager ones bit for bit; the report names the
programs captured and the signatures that stayed eager.  Weights
come from ``test.weight_file`` (a model file of ``training/checkpoints.py``,
the reference's torch format, or a JAX package ``model_*`` file), or are
seeded random (``models.init_random``, seed 0) when the key is absent.
The model is built from ``models.evaluation_config(config)``: under
``model.compute_dtype: bfloat16`` the shipped pair evaluates in float32, as
``test.py`` does on its accelerator, and an ablation pair in bfloat16.
"""

import argparse
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from nsdp_tpu_torch import resolve_device
from nsdp_tpu_torch.data import DataLoader, dataset_dict, split_batch
from nsdp_tpu_torch.models import build_model, evaluation_config, init_random
from nsdp_tpu_torch.training import make_steps, optimizer_factory, read_state_dict
from nsdp_tpu_torch.training.steps import test_on_batch
from nsdp_tpu_torch.utils.config import load_config
from nsdp_tpu_torch.utils.generation import generate_meshes, generate_pointclouds
from nsdp_tpu_torch.utils.logger import StatsLogger
from nsdp_tpu_torch.utils.metrics import compute_evaluation_metrics

# the JAX CLIs' precision names -> torch.set_float32_matmul_precision:
# 'highest' keeps float32 products, the others let cuBLAS use TF32
MATMUL_PRECISION = {"default": "high", "high": "high", "highest": "highest"}


def parse_args(argv, description="Evaluate a deformation network"):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("config_file", help="experiment configuration YAML")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="data loader threads (0: load in the main thread)")
    parser.add_argument("--num_threads", type=int, default=4,
                        help="PyTorch's CPU threads (torch.set_num_threads)")
    parser.add_argument("--matmul_precision", default="default",
                        choices=sorted(MATMUL_PRECISION))
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, the plain PyTorch path")
    return parser.parse_args(argv)


def prepare(args, what: str):
    """Everything both evaluation entry points set up before their loop ->
    (config, experiment directory, dataset, loader, steps)."""
    device = resolve_device(args.device)
    torch.set_num_threads(args.num_threads)
    torch.set_float32_matmul_precision(MATMUL_PRECISION[args.matmul_precision])
    print("Running on", torch.cuda.get_device_name(device) if device.type == "cuda" else device)
    config = load_config(args.config_file)

    experiment_directory = os.path.join(config["experiment"]["out_dir"],
                                        config["experiment"]["name"])
    os.makedirs(experiment_directory, exist_ok=True)

    tcfg = config["test"]
    dataset = dataset_dict[config["data"]["type"]](
        config,
        iden_split=tcfg["iden_split"],
        motion_split=tcfg["motion_split"],
        load_mesh=tcfg["load_mesh"],
        num_sampled_pairs=tcfg["num_sampled_pairs"],
    )
    loader = DataLoader(dataset, batch_size=tcfg.get("batch_size", 1), shuffle=False,
                        num_workers=args.num_workers)
    print(f"Loaded {len(dataset)} {what}")
    # test.py draws item 0 as its model's example input; drawing it here as
    # well keeps the dataset's random stream, and so every pair, the same
    # as test.py's for the same global seed
    dataset[0]

    model = build_model(evaluation_config(config), device=device)
    weight_file = tcfg.get("weight_file")
    if weight_file:
        print(f"Loading weight file from {weight_file}")
        model.load_state_dict(read_state_dict(weight_file), strict=True)
    else:
        init_random(model, 0)
    _, optimizer = optimizer_factory(config.get("training", {}), model.parameters())
    steps = make_steps(model, config["model"]["type"], optimizer, device=device)
    return config, experiment_directory, dataset, loader, steps


def output_dirs(config, directory: str):
    """(mesh directory, point cloud directory) under ``directory``, each
    created, or None where the config asks for no such output."""
    dirs = []
    for flag, folder, what in (("generate_mesh", "mesh_folder", "meshes"),
                               ("generate_pointcloud", "pointcloud_folder", "pointclouds")):
        path = None
        if config["test"][flag]:
            path = os.path.join(directory, config["test"][folder])
            os.makedirs(path, exist_ok=True)
            print(f"Save generated {what} in {path}")
        dirs.append(path)
    return dirs


def report_programs(steps, names=("predict",)) -> None:
    """One line: the captured programs of the step functions ``names`` (a
    ``Graphs`` shared by several is reported once; a function without one,
    such as a caller's wrapper, none), their replays and the signatures
    that ran only eagerly."""
    seen, parts = set(), []
    for name in names:
        graphs = getattr(steps[name], "graphs", None)
        if graphs is not None and id(graphs) not in seen:
            seen.add(id(graphs))
            parts.append(f"{name}: {graphs.describe()}")
    print(f"Programs: {'; '.join(parts) if parts else 'none (eager)'}")


def report_times(times: Dict[str, List[float]], pairs: int) -> None:
    """One line: the wall time per pair of each stage of the loop."""
    split = ", ".join(f"{k} {sum(v) / max(pairs, 1):.4f} s" for k, v in times.items())
    print(f"Wall time per pair ({pairs} pairs): {split}")


def main(argv) -> Dict[str, List[float]]:
    """Run the evaluation; returns the wall times (s) of its stages: per
    batch ``data`` (assembly) and ``test_on_batch`` (both evaluations and
    their copies), per pair ``metrics`` and ``writers``."""
    args = parse_args(argv)
    config, experiment_directory, dataset, loader, steps = prepare(
        args, "test deformation pairs")
    tcfg = config["test"]

    StatsLogger.reset()  # a logger of this run's own
    logger = StatsLogger.instance()
    stats = open(os.path.join(experiment_directory, f"{tcfg['motion_split']}.txt"), "w")
    logger.add_output_file(stats)
    mesh_dir, pc_dir = output_dirs(
        config, os.path.join(experiment_directory, tcfg["motion_split"]))

    times = {"data": [], "test_on_batch": [], "metrics": [], "writers": []}
    print("====> Inference / Test ====>")
    with stats:
        t0 = time.perf_counter()
        for b, batch in enumerate(loader):
            t1 = time.perf_counter()
            loss, batch = test_on_batch(steps, batch, compute_loss=True)
            times["data"].append(t1 - t0)
            times["test_on_batch"].append(time.perf_counter() - t1)

            # the device evaluates the whole batch; metrics and writers take
            # one pair at a time (the reference runs batch_size 1)
            for sample in split_batch(batch):
                t0 = time.perf_counter()
                for k, v in compute_evaluation_metrics(sample).items():
                    if v <= 1.0:
                        logger[k].value = v
                t1 = time.perf_counter()
                meta_data = dataset.get_metadata(int(np.asarray(sample["index"]).squeeze()))
                if mesh_dir:
                    generate_meshes(mesh_dir, sample, meta_data, tcfg["mesh_format"],
                                    vert_pred_color=True)
                if pc_dir:
                    generate_pointclouds(pc_dir, sample, meta_data, tcfg["pointcloud_format"])
                times["metrics"].append(t1 - t0)
                times["writers"].append(time.perf_counter() - t1)
            logger.print_progress(-1, b + 1, loss)
            t0 = time.perf_counter()
        logger.clear()
    print("====> Inference / Test ====>")
    report_times(times, len(times["metrics"]))
    report_programs(steps)
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
