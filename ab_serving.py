#!/usr/bin/env python3
"""Time the port's serving path in one checkout, to compare two versions.

    python3 ab_serving.py <checkout>      # needs one CUDA card

Imports ``nsdp_tpu_torch`` from ``<checkout>`` and serves its full-width
``configs/deform4d/arbitrary.yaml`` model (seeded random weights) on a
5000-point sphere: 30 evaluations at Q = 65,536, then an edit session at
Q = 20,000 and 20 drags, timed on the host clock around the numpy-in,
numpy-out calls; then one evaluation traced with ``torch.profiler`` for
its count of device activities.  Host times vary from call to call of the
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
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from nsdp_tpu_torch.serving import DeformationService  # noqa: E402
from nsdp_tpu_torch.utils.config import load_config  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.RandomState(0)
v = rng.randn(5000, 3)
v /= np.linalg.norm(v, axis=1, keepdims=True)
surf = v.astype(np.float32)
handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
tgt = (surf + 0.2) * handle
inputs = np.concatenate([surf, tgt, handle], -1)
svc = DeformationService(
    load_config(os.path.join(root, "configs/deform4d/arbitrary.yaml")), device="cuda", seed=0)
svc.warmup(5000)
pts = rng.uniform(-1.3, 1.3, (65536, 3)).astype(np.float32)
ev = []
for _ in range(30):
    t0 = time.perf_counter()
    svc.deform(pts, inputs)
    ev.append((time.perf_counter() - t0) * 1e3)
sess = svc.edit_session(pts[:20000], surf)
dr = []
for i in range(20):
    t0 = time.perf_counter()
    sess.drag(tgt * (1 - 0.01 * i), handle)
    dr.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    svc.deform(pts, inputs)
    torch.cuda.synchronize()
n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
print(f"AB {os.path.basename(root) or root}: eval median {np.median(ev):.2f} min {min(ev):.2f} ms;"
      f" drag median {np.median(dr):.2f} min {min(dr):.2f} ms; {n} device activities", flush=True)
