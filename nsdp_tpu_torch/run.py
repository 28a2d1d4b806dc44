"""Handle-based shape editing: the port's counterpart of ``run.py``.

    python -m nsdp_tpu_torch.run CONFIG [--num_workers N] [--num_threads N]
        [--matmul_precision default|high|highest] [--device cuda|cpu]

The flags and the set-up are those of :mod:`nsdp_tpu_torch.test`, but the
dataset (``tosca`` / ``dogrec``) synthesises the target pose from the
configured user handle, no metrics are computed, and the outputs go to a
folder named after the handle and its translation
(``<out_dir>/<name>/drag_head_x-0.15y-0.20z-0.20_ratio0.10/``), meshes and
point clouds only where the config asks for them.  These datasets condition
on every mesh vertex, so the encoders see the whole mesh.  On the card a
signature seen once (a mesh's own shapes) runs eagerly and captures
nothing; one seen again replays a CUDA graph (``make_steps``' ``predict``).
"""

import os
import sys
import time
from typing import Dict, List

import numpy as np

from nsdp_tpu_torch.data import split_batch
from nsdp_tpu_torch.test import (
    output_dirs,
    parse_args,
    prepare,
    report_programs,
    report_times,
)
from nsdp_tpu_torch.training.steps import test_on_batch
from nsdp_tpu_torch.utils.generation import (
    define_userhandle_folder_name,
    generate_meshes,
    generate_pointclouds,
)
from nsdp_tpu_torch.utils.logger import StatsLogger


def main(argv) -> Dict[str, List[float]]:
    """Run the edits; returns the wall times (s) of their stages: per batch
    ``data`` and ``test_on_batch``, per pair ``writers``."""
    args = parse_args(argv, "Handle-based shape editing with a deformation prior")
    config, experiment_directory, dataset, loader, steps = prepare(args, "editing samples")
    tcfg = config["test"]
    mesh_dir, pc_dir = output_dirs(
        config, os.path.join(experiment_directory, define_userhandle_folder_name(config)))

    StatsLogger.reset()  # a logger of this run's own
    logger = StatsLogger.instance()
    times = {"data": [], "test_on_batch": [], "writers": []}
    print("====> Interactive Editing ====>")
    t0 = time.perf_counter()
    for b, batch in enumerate(loader):
        t1 = time.perf_counter()
        _, batch = test_on_batch(steps, batch, compute_loss=False)
        times["data"].append(t1 - t0)
        times["test_on_batch"].append(time.perf_counter() - t1)
        logger.print_progress(-1, b + 1, 0.0)
        for sample in split_batch(batch):
            t1 = time.perf_counter()
            meta_data = dataset.get_metadata(int(np.asarray(sample["index"]).squeeze()))
            if mesh_dir:
                generate_meshes(mesh_dir, sample, meta_data, tcfg["mesh_format"],
                                vert_pred_color=False)
            if pc_dir:
                generate_pointclouds(pc_dir, sample, meta_data, tcfg["pointcloud_format"])
            times["writers"].append(time.perf_counter() - t1)
        t0 = time.perf_counter()
    logger.clear()
    print("====> Interactive Editing ====>")
    report_times(times, len(times["writers"]))
    report_programs(steps)
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
