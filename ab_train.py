#!/usr/bin/env python3
"""Time the port's train step in one checkout, to compare two versions.

    python3 ab_train.py <checkout>      # needs one CUDA card

Imports ``nsdp_tpu_torch`` from ``<checkout>`` and takes train steps of its
full-width shipped ``configs/deform4d/forward.yaml`` (stage 1, batch 16)
and ``arbitrary.yaml`` (stage 2, batch 8) models with seeded random
weights, on seeded batches already on the card (N = Q = 5000, a handle
mask): 2 warm-up steps, then 10 steps each timed on the host clock around
``train_step(batch, lr)`` (which reads its loss back) and a
``torch.cuda.synchronize()``.  Host times vary from call to call of the
machine, so compare two checkouts only within one call, in the order
parent, change, change, parent.
"""

import os
import sys
import time

import numpy as np

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch  # noqa: E402

from nsdp_tpu_torch.models import build_model, init_random  # noqa: E402
from nsdp_tpu_torch.training import make_steps, optimizer_factory  # noqa: E402
from nsdp_tpu_torch.utils.config import load_config  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.RandomState(0)
line = []
for label, B in (("forward", 16), ("arbitrary", 8)):
    cfg = load_config(os.path.join(root, "configs", "deform4d", f"{label}.yaml"))
    model = init_random(build_model(cfg, device="cuda"), 0)
    schedule, opt = optimizer_factory(cfg["training"], model.parameters())
    steps = make_steps(model, label, opt, device="cuda")
    batches = []
    for _ in range(12):
        src, tgt = rng.randn(B, 5000, 3), rng.randn(B, 5000, 3)
        mask = (rng.rand(B, 5000, 1) > 0.5).astype(np.float64)
        batch = {"surface_samples_inputs": np.concatenate([src, tgt * mask, mask], -1),
                 "space_samples_src": rng.randn(B, 5000, 3),
                 "space_samples_tgt": rng.randn(B, 5000, 3)}
        batches.append({k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
                        for k, v in batch.items()})
    lr = schedule.get_learning_rate(0)
    times = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps["train_step"](batch, lr)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    line.append(f"{label} B={B} step median {np.median(times):.2f} min {min(times):.2f}"
                f" max {max(times):.2f} ms")
    del model, opt, steps, batches
    torch.cuda.empty_cache()
print(f"AB {os.path.basename(root) or root}: {'; '.join(line)}", flush=True)
