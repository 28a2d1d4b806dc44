#!/usr/bin/env python3
"""Time K3 (FPS) and K4 (kNN) at phase 2's sites in one checkout, and ``run``
on a 40,962-vertex mesh, to compare two versions of the two kernels.

    python3 ab_k34.py <checkout> [label] [--run]      # needs one CUDA card

Imports ``nsdp_tpu_torch`` from ``<checkout>`` and ``chip_smoke.py`` from
this script's directory, builds the checkout's kernels, and runs:
- K3 on phase 2's clouds of 14,497, 50,000, 40,962 and 120,000 points
  (the same seed) and the 5000-point surface, each sampled to 500 points:
  the median call time (CUDA events) and whether the indices equal
  ``furthest_point_sample_plain``'s;
- K4 at phase 2's sites (``chip_smoke.knn_sites``, inputs made as phase 2
  makes them, from their own seed): the device time (``torch.profiler``)
  and whether indices and distances equal ``knn_plain``'s; then K4's time
  per evaluation of configuration A;
- with ``--run``, ``python -m nsdp_tpu_torch.run`` (in process) on
  ``configs/tosca/head.yaml`` with a 40,962-vertex mesh and seeded weights,
  four times: ``test_on_batch`` of each run and the median of the last
  three (the first pays the set-up).
Compare two checkouts only within one call, in turns (parent, change,
change, parent).
"""

import importlib.util
import os
import sys
import tempfile

checkout = os.path.abspath(sys.argv[1])
args = [a for a in sys.argv[2:] if a != "--run"]
label = args[0] if args else os.path.basename(checkout)
sys.path.insert(0, checkout)
import numpy as np  # noqa: E402
import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from nsdp_tpu_torch.ops import _build, fps, knn  # noqa: E402

if not torch.cuda.is_available():
    cs.fail("no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()

big = np.random.RandomState(1)  # phase 2's large clouds, in its order
clouds = {}
for n in (14497, 50000, 40962, 120000):
    clouds[n] = cs.surface(big, n)
    clouds[n][big.choice(n, n // 100, replace=False)] = 0.0
rng = np.random.RandomState(0)
surf = cs.surface(rng, 5000)
clouds[5000] = surf
for n, cloud in clouds.items():
    x = torch.as_tensor(cloud[None], device="cuda")
    equal = torch.equal(fps.furthest_point_sample(x, 500), fps.furthest_point_sample_plain(x, 500))
    ms = cs.time_ms(torch, lambda: fps.furthest_point_sample(x, 500), 10)
    print(f"AB {label} K3 {n}->500 {ms:.4f} ms indices {'equal' if equal else 'DIFFER'}",
          flush=True)

total = 0.0
for site in cs.knn_sites():
    name, per_eval, B, nq, m, k, masked, rd = site
    if name == "large_cloud":
        kv = torch.as_tensor(cs.surface(rng, m)[None], device="cuda")
        q = kv[:, torch.as_tensor(rng.choice(m, nq, replace=False), device="cuda")]
    else:
        x, c500, c100 = cs.clouds(torch, rng, surf, B)
        q, kv = {(500, 5000): (c500, x), (100, 500): (c100, c500), (5000, 5000): (x, x)}[(nq, m)]
    mask = None
    if masked:
        mask = torch.ones((B, m), device="cuda")
        mask[:, -m // 10:] = 0.0
    run = lambda: knn.knn(q, kv, k, return_dist=True, kv_mask=mask)
    got, ref = run(), knn.knn_plain(q, kv, k, return_dist=True, kv_mask=mask)
    equal = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    ms = cs.device_ms(torch, lambda: knn.knn(q, kv, k, return_dist=rd, kv_mask=mask), 20)
    total += per_eval * ms
    print(f"AB {label} K4 {name:<15} {ms:.4f} ms indices and distances"
          f" {'equal' if equal else 'DIFFER'}", flush=True)
print(f"AB {label} K4 per evaluation of A {total:.4f} ms", flush=True)

if "--run" in sys.argv[2:]:
    from nsdp_tpu_torch import run as port_run
    from nsdp_tpu_torch.data.synthetic import generate_userhandle_dataset
    from nsdp_tpu_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as root:
        mesh = generate_userhandle_dataset(os.path.join(root, "mesh"), subdivisions=6)
        weight_file, _ = cs.seeded_weight_file(
            torch, load_config(os.path.join(checkout, "configs", "deform4d", "arbitrary.yaml")),
            root)
        uh = load_config(os.path.join(checkout, "configs", "tosca", "head.yaml"))
        uh["test"]["weight_file"] = weight_file
        uh["experiment"]["out_dir"] = os.path.join(root, "run")
        uh["data"].update(dataset_dir=mesh["dataset_dir"], split_dir=mesh["split_dir"])
        path = cs.write_config(uh, os.path.join(root, "run.yaml"))
        argv = ["--matmul_precision", "highest", "--num_threads", str(os.cpu_count())]
        tob = [t * 1e3 for _ in range(4) for t in port_run.main([path, *argv])["test_on_batch"]]
    print(f"AB {label} run on 40962 vertices: test_on_batch {', '.join(f'{t:.1f}' for t in tob)}"
          f" ms; median of the last 3 {np.median(tob[-3:]):.2f} ms", flush=True)
