#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nsdp_tpu_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero and prints no result line):

1. setup: TF32 off, the card's name and power limit, the CUDA kernels built
   from ``nsdp_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel); per
   kernel ptxas's registers, shared memory and spills, and the count of
   tensor-core (``HMMA``) instructions in its SASS -- none in K2's
   ``bwd_rows_kernel`` or ``wgrad_kernel`` fails;
2. kernels: each hand-written forward kernel held against its plain PyTorch
   version at every shape the main path gives it -- fused kNN attention
   (K1) within rtol 1e-4 / atol 1e-5, furthest-point sampling (K3) index
   for index, K4 (kNN) index for index and distance for distance, the row
   gather (P1/P2) bit for bit -- and timed beside it (CUDA events, median;
   K4 and the gather, whose calls are shorter than their host dispatch, by
   the device time ``torch.profiler`` records); the gather also beside
   ``torch.gather``, one PyTorch call that computes it (the port never
   calls it); K1's device time split by CUDA kernel (``torch.profiler``);
2b. K2, the attention's backward, at every training site (batch 2): each
   gradient's relative L2 error against the plain version run in float64
   on the card at most twice the float32 plain version's (floor 1e-6);
   ``gamma_b1``'s gradient, analytically zero, absolutely (at most 1e-4 of
   the largest ``gamma_w1`` gradient); then K2 and the plain backward timed
   at the training batch, K2's device time split by CUDA kernel, and
   ``wgrad_cublas_ms``: cuBLAS's time for the four weight-gradient products
   at the same shapes, a yardstick the port never calls;
3. serving: the shipped full-width ``configs/deform4d/arbitrary.yaml``
   model with seeded random weights warms up (``warmup``), then serves
   three ``deform`` requests (Q = 3000, 20000 masked, 65536) and an edit
   session with two drags; the launch counters must show 17 K1 and 4 K3
   launches (and no K2, K4 or gather) per full evaluation and 8 + 2 per
   drag (the forward half only); then one evaluation is traced with
   ``torch.profiler``: device time by kind and the device's idle share;
3b. training: the shipped ``forward`` and ``backward`` (batch 16) and
   ``arbitrary`` (batch 8) models at full width with seeded random weights
   take a warm-up and 4 timed train steps on seeded batches (N = Q = 5000,
   a handle mask); every step must launch K1/K2/K3 8/8/2, 8/8/2 and
   17/17/4 times, every loss be finite, the parameters move; median step
   time and peak device memory; one stage-2 step traced; a checkpoint
   saved and resumed gives the same next loss;
3c. serving the encoder ablation, configuration A (``ablation_config``:
   ``arbitrary.yaml`` with the ``pointnet++`` encoder, full width, seeded
   random weights) as phase 3 serves the shipped model: 3 K1 / 4 K3 / 4 K4
   / 4 gather launches per full evaluation, 1 / 2 / 2 / 2 per drag,
   2 / 2 / 2 / 2 per edit session; the median evaluation at Q = 65536, the
   drags at Q = 20000 and one traced evaluation;
3d. training the two ablations at full width: A in stage 2 (B = 8, K1/K2/
   K3/K4/gather 3/3/4/4/4 per step) and B (``forward.yaml`` with the
   ``pointnet++`` encoder and the ``interp`` decoder) in stage 1 (B = 16,
   0/0/2/2/2), a warm-up and 4 timed steps each on batches with a handle
   mask (B's queries near its surface, where the interpolation weights do
   not underflow): losses finite, parameters moved, step time and peak
   memory, one step of each traced;
4. reference: the card's canonicalize and deform halves against the plain
   PyTorch path on the CPU, at full width on a small query set (within
   rtol 1e-3 / atol 2e-4 of the float32 path -- or, where the float32 path
   itself errs beyond that against float64, with a largest absolute error
   against float64 at most twice the float32 path's -- and as close to the
   float64 path, by relative L2 error, as the float32 path within a factor
   of 2), and the whole predict at a tiny width;
4b. one full-width stage-2 train step (batch 1, N = 5000, Q = 1024) on the
   card against the CPU plain path in float32 and float64, by halves cut at
   the canonical pose as phase 4 compares (the CPU paths take the card's
   canonicalised points and their gradients, so every selection sees the
   same coordinates): the loss within
   rtol 1e-4, the canonicalised points' gradients, every parameter gradient
   and every BatchNorm running statistic after the step (compound EMA
   included) by the phase-2b rule, widened to 4 times the float32 path's
   error with a floor of 1e-4 (ReLU near-ties: see the phase);
   gradients that vanish analytically (a bias that the slot softmax or a
   train-mode BatchNorm right after it cancels) are held absolutely, as
   ``gamma_b1`` is in phase 2b;
4c. configuration A by phases 4 and 4b's rules: its halves at full width
   on a small query set and a tiny predict, then one full-width stage-2
   step by halves (on a batch seed without near-ties, as phase 4b's).

The second-to-last lines are the card (``nvidia-smi``) and a ``kernels``
JSON object (K1's and K2's entries also carry ``bound_tc_ms``, their bound
were their D x D products all on the tensor cores in 3xTF32); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "deform4d", "arbitrary.yaml")
# H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate (700 W part);
# 3xTF32 on the tensor cores: three TF32 products (495 TFLOP/s dense) per one
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
K1_TOL = dict(rtol=1e-4, atol=1e-5)
E2E_TOL = dict(rtol=1e-3, atol=2e-4)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Median time of ``fn`` on the card (CUDA events), after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_events(torch, fn, reps: int):
    """The device activities ``torch.profiler`` records over ``reps`` calls
    of ``fn``, after one warm call.  A profiling session now and then
    delivers no device activity at all; the measurement is then taken
    again, three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return events
    fail("the profiler recorded no device activity")


def device_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    device activities over ``reps`` calls, over ``reps``.  For calls
    shorter than their host dispatch, where CUDA events (:func:`time_ms`)
    time the host."""
    return sum(e.time_range.elapsed_us() for e in device_events(torch, fn, reps)) / 1e3 / reps


def kernel_name(name: str) -> str:
    """A device activity's kernel name without its return type, namespaces
    and template arguments (``void (anonymous namespace)::attn_kernel<4>(...)``
    -> ``attn_kernel``)."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.split("::")[-1].replace("void ", "").strip() or "?"


def kernel_split(torch, fn, reps: int) -> dict:
    """Device time of one call of ``fn``, by CUDA kernel name (ms)."""
    split = {}
    for e in device_events(torch, fn, reps):
        key = kernel_name(e.name)
        split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return split


def format_split(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))


def bound(flops: float, nbytes: float):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_tc(row) -> float:
    """Least time in ms of a K1 or K2 site with its D x D products on the
    tensor cores in 3xTF32 (165 TFLOP/s) and the rest of its operations in
    f32 (67 TFLOP/s), or its bytes, whichever is longer."""
    mm = row["mm_flops"]
    t_ops = (mm / PEAK_3XTF32_FLOPS + (row["flops"] - mm) / PEAK_F32_FLOPS) * 1e3
    return max(t_ops, row["bytes"] / PEAK_BYTES * 1e3)


def surface(rng, n: int) -> np.ndarray:
    """A closed blobby surface around the origin (every point is an FPS
    candidate: |p|^2 ~ 1)."""
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta, phi = np.arccos(v[:, 2]), np.arctan2(v[:, 1], v[:, 0])
    r = 1.0 + 0.25 * np.sin(3 * theta) * np.cos(2 * phi)
    return (v * r[:, None] * np.array([1.0, 0.7, 1.3])).astype(np.float32)


def ablation_config(name: str) -> dict:
    """Configuration A (the encoder ablation: ``arbitrary.yaml`` with the
    ``pointnet++`` encoder) or B (the decoder ablation: ``forward.yaml`` with
    the ``pointnet++`` encoder and the ``interp`` decoder), built from the
    shipped config as the JAX package's tests build theirs: the module
    swapped, the shipped widths kept (5000 -> 500 -> 100 points, k = 16,
    d_transformer 256, three group-all blocks; decoder ``dim`` 200,
    ``hidden_dim`` 128)."""
    from nsdp_tpu_torch.utils.config import load_config

    shipped = "arbitrary" if name == "A" else "forward"
    cfg = load_config(os.path.join(REPO, "configs", "deform4d", f"{shipped}.yaml"))
    model = cfg["model"]
    model["encoder"] = "pointnet++"
    for key in ("nneighbor_reduced", "d_reduced", "full_SA"):
        model["encoder_kwargs"].pop(key)
    if name == "B":
        model["decoder"] = "interp"
        model["decoder_kwargs"].pop("nneigh")
    return cfg


# ---------------------------------------------------------------- phase 2


def k1_sites():
    """The attention launches of one full evaluation at Q = 65536, then the
    other shapes the served requests give it (a masked request, the 4096
    bucket), which count 0 launches per evaluation:
    (name, launches per evaluation, Nq, M, k, D, mode, masked)."""
    return [
        ("bwd_encoder_begin", 1, 5000, 5000, 10, 120, "pos_only", False),
        ("fwd_encoder_begin", 1, 5000, 5000, 10, 120, "featured", False),
        ("set_abstraction_0", 4, 500, 5000, 16, 120, "featured", False),
        ("transformer_downs_0", 2, 500, 500, 16, 120, "featured", False),
        ("set_abstraction_1", 4, 100, 500, 16, 256, "featured", False),
        ("transformer_downs_1", 2, 100, 100, 16, 256, "featured", False),
        ("decoder_queries", 2, 65536, 100, 7, 200, "global", False),
        ("decoder_surface", 1, 5000, 100, 7, 200, "global", False),
        ("bwd_encoder_begin_masked", 0, 5000, 5000, 10, 120, "pos_only", True),
        ("fwd_encoder_begin_masked", 0, 5000, 5000, 10, 120, "featured", True),
        ("set_abstraction_0_masked", 0, 500, 5000, 16, 120, "featured", True),
        ("decoder_queries_4096", 0, 4096, 100, 7, 200, "global", False),
    ]


def k1_inputs(torch, rng, surf, fps_500, fps_100, site, B=1):
    """The attention's arguments at ``site``: the clouds of the main path
    (the same cloud in every batch item), random features and weights."""
    name, _, nq, m, k, d, mode, masked = site
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, axis=0)
    cloud = {5000: surf, 500: surf[fps_500], 100: surf[fps_500][fps_100]}
    kv = cloud[m]
    if name.startswith("set_abstraction"):
        xyz_q = -cloud[nq]  # FPS centres; the set abstraction negates both sets
        kv = -kv
    elif mode == "global":
        xyz_q = rng.uniform(-1.3, 1.3, (nq, 3)) if nq != 5000 else surf
    else:
        xyz_q = kv
    w = [rng.randn(3, d) * 0.5, rng.randn(d) * 0.1, rng.randn(d, d) / np.sqrt(d),
         rng.randn(d) * 0.1, rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1,
         rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1]
    # the weights as the modules pass them: transposed views of nn.Linear's
    # (out, in) weights, read in place by the kernel
    weights = [t(x.T).t() if x.ndim == 2 else t(x) for x in w]
    args = dict(xyz_q=t(rep(xyz_q)), kv_xyz=t(rep(kv)), q_feats=None, K_a=None,
                V_a=None, weights=weights, k=k)
    if mode != "pos_only":
        args["K_a"], args["V_a"] = t(rng.randn(B, m, d)), t(rng.randn(B, m, d))
        if mode == "global":  # the decoder's query is one broadcast row
            args["q_feats"] = t(rng.randn(B, 1, d)).expand(B, nq, d)
            args["k_glob"], args["v_glob"] = t(rng.randn(B, d)), t(rng.randn(B, d))
        else:
            args["q_feats"] = t(rng.randn(B, nq, d))
    if masked:
        mask = np.ones((B, m), np.float32)
        mask[:, -m // 10:] = 0.0
        args["kv_mask"] = t(mask)
    return args


def k1_mm_flops(site):
    """Flops of the attention's D x D products at ``site``: three per
    neighbour slot, two for the global slot."""
    _, _, nq, m, k, d, mode, masked = site
    return float(nq * (k * 6 * d * d + (4 * d * d if mode == "global" else 0)))


def k1_work(site):
    """(flops, bytes) the attention at ``site`` must do and move."""
    _, _, nq, m, k, d, mode, masked = site
    glob = mode == "global"
    per_query = 9 * m + k * (6 * d * d + 20 * d) + (4 * d * d + 12 * d if glob else 0)
    floats = nq * 3 + m * 3 + nq * d  # queries, kv points, output
    floats += 3 * d + 4 * d + 3 * d * d  # fc_delta, fc_gamma
    if mode != "pos_only":
        floats += 2 * m * d + (d if glob else nq * d)  # K, V, q (one row if broadcast)
    floats += 2 * d if glob else 0
    floats += m if masked else 0
    return float(nq * per_query), float(4 * floats)


def check_kernels(torch, rng, surf):
    from nsdp_tpu_torch.ops import attention, fps

    x = torch.as_tensor(surf[None], device="cuda")
    fps_500 = fps.furthest_point_sample(x, 500)[0].cpu().numpy()
    fps_100 = fps.furthest_point_sample(
        torch.as_tensor(surf[fps_500][None], device="cuda"), 100)[0].cpu().numpy()

    rows = {"k1": [], "k3": [], "fps": (fps_500, fps_100)}
    for site in k1_sites():
        a = k1_inputs(torch, rng, surf, fps_500, fps_100, site)
        kw = {key: a[key] for key in ("k_glob", "v_glob", "kv_mask") if key in a}
        pos = (a["xyz_q"], a["kv_xyz"], a["q_feats"], a["K_a"], a["V_a"], *a["weights"])
        run = lambda: attention.fused_vector_attention(*pos, k=a["k"], **kw)
        penalty = attention.mask_penalty(a["kv_mask"]) if "kv_mask" in a else None
        run_plain = lambda: attention.fused_vector_attention_plain(
            *pos, a["k"], a.get("k_glob"), a.get("v_glob"), penalty)
        with torch.inference_mode():
            got = run()
            torch.cuda.synchronize()
            ref = run_plain()
            err = float((got - ref).abs().max())
            if not torch.allclose(got, ref, **K1_TOL):
                fail(f"K1 at {site[0]}: max abs err {err} beyond {K1_TOL}")
            ms = time_ms(torch, run, 5)
            plain_ms = time_ms(torch, run_plain, 3)
            split = kernel_split(torch, run, 5)
        flops, nbytes = k1_work(site)
        rows["k1"].append(dict(site=site[0], per_eval=site[1], Nq=site[2], M=site[3],
                               k=site[4], D=site[5], ms=ms, plain_ms=plain_ms,
                               max_abs_err=err, flops=flops, bytes=nbytes, split=split,
                               mm_flops=k1_mm_flops(site)))
        log(f"K1 {site[0]:<26} Nq={site[2]:<6} M={site[3]:<5} k={site[4]:<3} D={site[5]:<4}"
            f" kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound(flops, nbytes)[0]:.4f} ms"
            f" ({bound(flops, nbytes)[1]}), on the tensor cores {bound_tc(rows['k1'][-1]):.4f} ms"
            f"  max_abs_err {err:.3g}")
        log(f"   device by kernel (ms): {format_split(split)}")

    for n, npoint, cloud in ((5000, 500, surf), (500, 100, surf[fps_500])):
        xyz = torch.as_tensor(cloud[None], device="cuda")
        got = fps.furthest_point_sample(xyz, npoint)
        torch.cuda.synchronize()
        ref = fps.furthest_point_sample_plain(xyz, npoint)
        if not torch.equal(got, ref):
            fail(f"K3 {n}->{npoint}: indices differ from the plain version")
        ms = time_ms(torch, lambda: fps.furthest_point_sample(xyz, npoint), 5)
        plain_ms = time_ms(torch, lambda: fps.furthest_point_sample_plain(xyz, npoint), 3)
        flops = float((npoint - 1) * n * 9 + n * 5)
        nbytes = float(n * 12 + npoint * 4)
        rows["k3"].append(dict(site=f"{n}->{npoint}", per_eval=2, ms=ms, plain_ms=plain_ms,
                               max_abs_err=0.0, flops=flops, bytes=nbytes))
        log(f"K3 fps {n}->{npoint}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
            f"  bound {bound(flops, nbytes)[0]:.6f} ms ({bound(flops, nbytes)[1]})  indices equal")
    return rows


def clouds(torch, rng, surf, B):
    """(cloud (B, 5000, 3), its 500 FPS centres, their 100 FPS centres) on
    the card: the surface itself at B = 1, jittered copies beyond."""
    from nsdp_tpu_torch.ops import fps, index_points

    pts = np.repeat(surf[None], B, axis=0)
    if B > 1:
        pts = pts + 0.01 * rng.randn(*pts.shape).astype(np.float32)
    x = torch.as_tensor(pts, device="cuda")
    c500 = index_points(x, fps.furthest_point_sample(x, 500))
    return x, c500, index_points(c500, fps.furthest_point_sample(c500, 100))


def knn_sites():
    """K4's shapes: (name, launches per full evaluation of configuration A,
    B, Nq, M, k, kv_mask, return_dist).  The set abstraction's grouping at
    both levels (2 launches each: one per encoder), at serving's B = 1 and
    training's B = 8; the non-fused JAX begin block (5000 x 5000, k = 10,
    B = 8, masked, with distances); a cloud larger than shared memory
    holds (14,496 points)."""
    return [
        ("sa_level0", 2, 1, 500, 5000, 16, False, False),
        ("sa_level1", 2, 1, 100, 500, 16, False, False),
        ("sa_level0_b8", 0, 8, 500, 5000, 16, False, False),
        ("sa_level1_b8", 0, 8, 100, 500, 16, False, False),
        ("begin_block_b8", 0, 8, 5000, 5000, 10, True, True),
        ("large_cloud", 0, 1, 2000, 20000, 16, False, True),
    ]


def knn_work(site):
    """(flops, bytes) of K4 at ``site``: 9 f32 operations per (query,
    point) pair (3 differences, 3 squares, 3 sums with the penalty);
    coordinates, mask and outputs once."""
    _, _, B, nq, m, k, masked, rd = site
    floats = B * (nq * 3 + m * 3 + nq * k * (2 if rd else 1) + (m if masked else 0))
    return float(9 * B * nq * m), float(4 * floats)


def check_knn(torch, rng, surf):
    """K4 against ``knn_plain`` on the card, index for index and distance
    for distance (phase 2)."""
    from nsdp_tpu_torch.ops.knn import knn, knn_plain

    rows = []
    for site in knn_sites():
        name, per_eval, B, nq, m, k, masked, rd = site
        if name == "large_cloud":
            kv = torch.as_tensor(surface(rng, m)[None], device="cuda")
            q = kv[:, torch.as_tensor(rng.choice(m, nq, replace=False), device="cuda")]
        else:
            x, c500, c100 = clouds(torch, rng, surf, B)
            q, kv = {(500, 5000): (c500, x), (100, 500): (c100, c500), (5000, 5000): (x, x)}[(nq, m)]
        mask = None
        if masked:
            mask = torch.ones((B, m), device="cuda")
            mask[:, -m // 10:] = 0.0
        run = lambda: knn(q, kv, k, return_dist=rd, kv_mask=mask)
        run_plain = lambda: knn_plain(q, kv, k, return_dist=rd, kv_mask=mask)
        got = run()
        torch.cuda.synchronize()
        ref = run_plain()
        got, ref = (got, ref) if rd else ((got, None), (ref, None))
        if not torch.equal(got[0], ref[0]):
            fail(f"K4 at {name}: indices differ from the plain version")
        if rd and not torch.equal(got[1], ref[1]):
            fail(f"K4 at {name}: distances differ from the plain version")
        ms, plain_ms = device_ms(torch, run, 10), device_ms(torch, run_plain, 3)
        wall_ms = time_ms(torch, run, 5)
        flops, nbytes = knn_work(site)
        rows.append(dict(site=name, per_eval=per_eval, ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
                         flops=flops, bytes=nbytes))
        t_b, by = bound(flops, nbytes)
        log(f"K4 {name:<15} B={B:<2} Nq={nq:<5} M={m:<6} k={k:<3} mask={masked:d} dist={rd:d}"
            f"  device: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {t_b:.6f} ms ({by});"
            f" call (events) {wall_ms:.4f} ms; indices{' and distances' if rd else ''} equal")
    return rows


def gather_sites():
    """The row gather's shapes: (name, launches per full evaluation of
    configuration A, B, M, W, S, k).  The set abstraction's grouping at
    both levels (B = 1 serving, B = 8 training) with the neighbourhoods K4
    selects there; the TPU probe's shape (``scripts/bench_gather_prefetch.py``:
    40 tiles x 128 queries x 16 slots from a (5120, 256) table, random
    indices)."""
    return [
        ("group_level0", 2, 1, 5000, 256, 500, 16),
        ("group_level1", 2, 1, 500, 256, 100, 16),
        ("group_level0_b8", 0, 8, 5000, 256, 500, 16),
        ("probe", 0, 1, 5120, 256, 40 * 128, 16),
    ]


def check_gather(torch, rng, surf):
    """The row gather against its plain version on the card, bit for bit,
    and timed beside ``torch.gather`` (phase 2)."""
    from nsdp_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from nsdp_tpu_torch.ops.knn import knn

    rows = []
    for name, per_eval, B, m, w, nq, k in gather_sites():
        table = torch.as_tensor(rng.randn(B, m, w).astype(np.float32), device="cuda")
        if name == "probe":
            idx = torch.as_tensor(rng.randint(0, m, (B, nq, k)).astype(np.int32), device="cuda")
        else:
            x, c500, c100 = clouds(torch, rng, surf, B)
            idx = knn(c500, x, k) if m == 5000 else knn(c100, c500, k)
        flat = idx.reshape(B, -1).long()[..., None].expand(-1, -1, w)
        run = lambda: gather_rows(table, idx)
        run_plain = lambda: gather_rows_plain(table, idx)
        run_library = lambda: torch.gather(table, 1, flat)
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, run_plain()) or not torch.equal(got.reshape(B, -1, w), run_library()):
            fail(f"gather at {name}: rows differ from the plain version")
        ms, plain_ms, library_ms = [device_ms(torch, f, 20) for f in (run, run_plain, run_library)]
        wall_ms = time_ms(torch, run, 10)
        nbytes = float(4 * (B * m * w + B * nq * k + B * nq * k * w))
        rows.append(dict(site=name, per_eval=per_eval, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_abs_err=0.0, flops=0.0, bytes=nbytes))
        log(f"gather {name:<16} B={B} table ({m}, {w}) by ({nq}, {k})  device: kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms  torch.gather {library_ms:.4f} ms"
            f"  bound {bound(0.0, nbytes)[0]:.4f} ms (bytes); call (events) {wall_ms:.4f} ms;"
            f" rows equal")
    return rows


def kernel_entry(name, source, replaces, rows, launches):
    """One kernel's entry of the ``kernels`` line: times and bounds summed
    over the launches of one pass of its path (a full evaluation for K1 and
    K3, a stage-2 train step for K2, a full evaluation of configuration A
    for K4 and the row gather)."""
    per_pass = lambda key: sum(r[key] * r["per_eval"] for r in rows)
    t_ops = per_pass("flops") / PEAK_F32_FLOPS * 1e3
    t_bytes = per_pass("bytes") / PEAK_BYTES * 1e3
    bound_ms = sum(bound(r["flops"], r["bytes"])[0] * r["per_eval"] for r in rows)
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_pass("ms"), "plain_ms": per_pass("plain_ms"), "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": per_pass("library_ms") if "library_ms" in rows[0] else None,
    }
    if "mm_flops" in rows[0]:  # K1, K2: the bound with the products on the tensor cores
        entry["bound_tc_ms"] = sum(bound_tc(r) * r["per_eval"] for r in rows)
    return entry


def check_gradient(what, card, f32, f64, partner_f64=None, factor=2.0, floor=1e-6):
    """Hold one gradient from the card against the plain path's float32 and
    float64 results -> the ratio of the card's relative L2 error to the
    float32 path's, or None for a gradient held absolutely.

    A gradient that vanishes analytically -- a bias cancelled by the slot
    softmax (``gamma_b1``) or by a train-mode BatchNorm right after it -- is
    rounding noise in float32 and ~0 in float64 (at most 1e-9 of its
    weight's gradient, ``partner_f64``): it is held absolutely, at most 1e-4
    of that scale.  Every other gradient's relative L2 error against
    float64 may be at most ``factor`` times the float32 path's, and never
    need be below ``floor``.
    """
    if partner_f64 is not None:
        scale = float(partner_f64.abs().max())
        if float(f64.abs().max()) <= 1e-9 * scale:
            err = float(card.abs().max())
            if err > 1e-4 * scale:
                fail(f"{what}: |gradient| {err:.3g}, analytically zero, beyond 1e-4 x {scale:.3g}")
            return None
    err, err_f32 = rel_err(card, f64), rel_err(f32, f64)
    if err > max(factor * err_f32, floor):
        fail(f"{what}: relative L2 error {err:.3g} against float64, more than {factor:g} times"
             f" the float32 plain path's {err_f32:.3g} and above {floor:g}")
    return err / max(err_f32, 1e-6)


# ---------------------------------------------------------------- phase 2b


def k2_sites():
    """The attention's backward at the training sites: (name, launches per
    stage-2 step, batch it is timed at, Nq, M, k, D, mode, masked).  The
    stage-1 nets run the same sites at batch 16 (one launch of each per
    net); the begin block is also timed there."""
    return [
        ("bwd_encoder_begin", 1, 8, 5000, 5000, 10, 120, "pos_only", False),
        ("fwd_encoder_begin", 1, 8, 5000, 5000, 10, 120, "featured", False),
        ("set_abstraction_0", 4, 8, 500, 5000, 16, 120, "featured", False),
        ("transformer_downs_0", 2, 8, 500, 500, 16, 120, "featured", False),
        ("set_abstraction_1", 4, 8, 100, 500, 16, 256, "featured", False),
        ("transformer_downs_1", 2, 8, 100, 100, 16, 256, "featured", False),
        ("decoder", 3, 8, 5000, 100, 7, 200, "global", False),
        ("bwd_encoder_begin_masked", 0, 8, 5000, 5000, 10, 120, "pos_only", True),
        ("fwd_encoder_begin_masked", 0, 8, 5000, 5000, 10, 120, "featured", True),
        ("fwd_encoder_begin_stage1", 0, 16, 5000, 5000, 10, 120, "featured", False),
    ]


K2_GRADS = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a", "delta_w0", "delta_b0", "delta_w1",
            "delta_b1", "gamma_w0", "gamma_b0", "gamma_w1", "gamma_b1", "k_glob", "v_glob")


def k2_work(site, B):
    """(flops, bytes) the backward at ``site`` must do and move: per
    neighbour row the three D x D products recomputed, three input-gradient
    and three weight-gradient products (18 D^2) plus O(D) elementwise work;
    a global-slot row needs no fc_delta (12 D^2)."""
    _, _, _, nq, m, k, d, mode, masked = site
    glob = mode == "global"
    flops = B * nq * (k * (18 * d * d + 40 * d) + (12 * d * d + 30 * d if glob else 0))
    floats = B * (2 * nq * 3 + 2 * m * 3 + nq * k + nq * d)  # coords and their grads, idx, g
    if mode != "pos_only":
        floats += B * (4 * m * d + (2 * d if glob else 2 * nq * d))  # K, V, q and their grads
    floats += B * 4 * d if glob else 0
    floats += B * m if masked else 0
    floats += 2 * (3 * d * d + 7 * d)  # weights and their gradients
    return float(flops), float(4 * floats)


def k2_mm_flops(site, B):
    """Flops of the backward's D x D products at ``site``: per neighbour
    row three recomputed, three input-gradient and three weight-gradient
    products (18 D^2), per global-slot row 12 D^2."""
    _, _, _, nq, m, k, d, mode, masked = site
    return float(B * nq * (k * 18 * d * d + (12 * d * d if mode == "global" else 0)))


def k2_operands(torch, a):
    from nsdp_tpu_torch.ops import attention

    ops = (a["xyz_q"], a["kv_xyz"], a["q_feats"], a["K_a"], a["V_a"], *a["weights"],
           a.get("k_glob"), a.get("v_glob"))
    penalty = attention.mask_penalty(a["kv_mask"]) if "kv_mask" in a else None
    idx = attention._launch(*ops[:13], a["k"], ops[13], ops[14], penalty)[1]
    return ops, idx


def check_backward(torch, rng, surf, fps_500, fps_100):
    """K2 against its plain version on the card (phase 2b)."""
    from nsdp_tpu_torch.ops import attention

    rows = []
    for site in k2_sites():
        k1_site = (site[0],) + site[1:2] + site[3:]
        a = k1_inputs(torch, rng, surf, fps_500, fps_100, k1_site, B=2)
        ops, idx = k2_operands(torch, a)
        g = torch.as_tensor(rng.randn(2, site[3], site[6]).astype(np.float32), device="cuda")
        got = attention.fused_vector_attention_backward(*ops, idx, g)
        torch.cuda.synchronize()
        f32 = attention.fused_vector_attention_bwd_plain(*ops, idx, g)
        f64 = attention.fused_vector_attention_bwd_plain(
            *[None if t is None else t.double() for t in ops], idx, g.double())
        worst, worst_abs = (0.0, ""), 0.0
        for name, x, y, z in zip(K2_GRADS, got, f32, f64):
            if x is None:
                continue
            partner = f64[K2_GRADS.index("gamma_w1")] if name == "gamma_b1" else None
            ratio = check_gradient(f"K2 at {site[0]}, d {name}", x, y, z, partner)
            worst = max(worst, (ratio or 0.0, name))
            worst_abs = max(worst_abs, float((x - y).abs().max()))
        del got, f32, f64
        B = site[2]
        a = k1_inputs(torch, rng, surf, fps_500, fps_100, k1_site, B=B)
        ops, idx = k2_operands(torch, a)
        g = torch.as_tensor(rng.randn(B, site[3], site[6]).astype(np.float32), device="cuda")
        run = lambda: attention.fused_vector_attention_backward(*ops, idx, g)
        ms = time_ms(torch, run, 3)
        plain_ms = time_ms(torch, lambda: attention.fused_vector_attention_bwd_plain(*ops, idx, g), 2)
        split = kernel_split(torch, run, 3)
        n_rows = B * site[3] * (site[5] + (site[7] == "global"))
        cublas_ms = wgrad_cublas_ms(torch, n_rows, site[6])
        flops, nbytes = k2_work(site, B)
        ws_gb = 4 * attention.backward_workspace_floats(
            B, site[3], site[5], site[6], site[7] == "global") / 1e9
        rows.append(dict(site=site[0], per_eval=site[1], B=B, Nq=site[3], M=site[4], k=site[5],
                         D=site[6], ms=ms, plain_ms=plain_ms, max_abs_err=worst_abs,
                         flops=flops, bytes=nbytes, workspace_gb=ws_gb, split=split,
                         wgrad_cublas_ms=cublas_ms, mm_flops=k2_mm_flops(site, B)))
        t_b, by = bound(flops, nbytes)
        log(f"K2 {site[0]:<26} B={B:<3} Nq={site[3]:<5} M={site[4]:<5} k={site[5]:<3} D={site[6]:<4}"
            f" kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {t_b:.4f} ms ({by}), on the"
            f" tensor cores {bound_tc(rows[-1]):.4f} ms  workspace {ws_gb:.3f} GB  largest error ratio to float32 plain {worst[0]:.3g}"
            f" (d {worst[1]})"
            f"  max_abs_err vs float32 plain {worst_abs:.3g}")
        log(f"   device by kernel (ms): {format_split(split)}; wgrad_cublas_ms {cublas_ms:.4f}")
        del ops, idx, g, a
    return rows


def wgrad_cublas_ms(torch, n_rows: int, D: int) -> float:
    """A yardstick for K2's weight-gradient reduction: ``torch.matmul(X.T,
    Y)`` over the four ``[X | 1]^T Y`` products at the workspace's shapes
    (X of 3 + 1 and D + 1 columns, Y of D, ``n_rows`` rows each).  It is not
    K2's ``library_ms`` (it computes only this part of K2), and the port
    never calls it."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    Y = torch.randn(n_rows, D, device="cuda", generator=gen)
    X = [torch.randn(n_rows, dx + 1, device="cuda", generator=gen) for dx in (3, D, D, D)]
    ms = time_ms(torch, lambda: [torch.matmul(x.T, Y) for x in X], 3)
    del X, Y
    return ms


# ---------------------------------------------------------------- phase 3


def counts():
    """Launches so far of (K1, K2, K3, K4, the row gather)."""
    from nsdp_tpu_torch.ops import attention, fps, gather, knn

    return (attention.fused_vector_attention.launches,
            attention.fused_vector_attention_backward.launches,
            fps.furthest_point_sample.launches, knn.knn.launches, gather.gather_rows.launches)


def reset_counts():
    from nsdp_tpu_torch.ops import attention, fps, gather, knn

    attention.fused_vector_attention.launches = 0
    attention.fused_vector_attention_backward.launches = 0
    fps.furthest_point_sample.launches = 0
    knn.knn.launches = 0
    gather.gather_rows.launches = 0


def expect_launches(before, want, what):
    got = tuple(a - b for a, b in zip(counts(), before))
    if got != want:
        fail(f"{what}: {' / '.join(map(str, got))} K1 / K2 / K3 / K4 / gather launches,"
             f" expected {' / '.join(map(str, want))}")


def check_output(out, shape, what):
    if out.shape != shape or not np.isfinite(out).all():
        fail(f"{what}: output {out.shape} (finite: {np.isfinite(out).all()}), expected {shape}")


# launches (K1, K2, K3, K4, gather) per full evaluation, edit session and drag
SERVE_LAUNCHES = {
    "shipped": {"deform": (17, 0, 4, 0, 0), "session": (9, 0, 2, 0, 0), "drag": (8, 0, 2, 0, 0)},
    # two pointnet++ encoders (FPS + K4 + gather at each of 2 levels) and
    # three crossatten decodes; a session canonicalises, a drag deforms
    "A": {"deform": (3, 0, 4, 4, 4), "session": (2, 0, 2, 2, 2), "drag": (1, 0, 2, 2, 2)},
}


def serve(torch, rng, surf, config, label):
    """Serve ``config`` with seeded random weights: a warm-up, three
    requests, an edit session with two drags (the main path, its launches
    checked against ``SERVE_LAUNCHES[label]``), then timings and a traced
    evaluation.  -> (service, launches of the main path)."""
    from nsdp_tpu_torch.serving import DeformationService

    want = SERVE_LAUNCHES[label]
    svc = DeformationService(config, device="cuda", seed=0)
    n = surf.shape[0]
    handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
    tgt = (surf + np.array([0.25, 0.0, 0.1], np.float32)) * handle
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(n, np.float32)
    pm[-500:] = 0.0  # a padded-partial cloud: padded rows at the origin
    requests = [(3000, None), (20000, pm), (65536, None)]
    queries = {q: rng.uniform(-1.3, 1.3, (q, 3)).astype(np.float32) for q, _ in requests}
    t0 = time.perf_counter()
    svc.warmup(n)  # every entry at every bucket: cuBLAS and allocator set-up
    torch.cuda.synchronize()
    log(f"serving {label}: warmup (3 buckets, plain + masked + edit session)"
        f" {time.perf_counter() - t0:.2f} s")

    stats = {}
    reset_counts()  # ---- the main path: requests, a session, two drags
    for q, mask in requests:
        inp = inputs if mask is None else inputs * mask[:, None]
        before = counts()
        t0 = time.perf_counter()
        out = svc.deform(queries[q], inp, point_mask=mask)
        dt = time.perf_counter() - t0
        expect_launches(before, want["deform"], f"{label} deform Q={q}")
        check_output(out, (q, 3), f"{label} deform Q={q}")
        stats[f"deform_ms_q{q}"] = dt * 1e3
    eval_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        svc.deform(queries[65536], inputs)
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    stats["eval_ms_q65536"] = float(np.median(eval_ms))
    stats["qps_q65536"] = 65536 / (stats["eval_ms_q65536"] / 1e3)

    pts = queries[20000]
    before = counts()
    session = svc.edit_session(pts, surf)
    expect_launches(before, want["session"], f"{label} edit_session")
    drag_ms = []
    for scale in (1.0, 0.5):
        before = counts()
        t0 = time.perf_counter()
        dragged = session.drag(tgt * scale, handle)
        drag_ms.append((time.perf_counter() - t0) * 1e3)
        expect_launches(before, want["drag"], f"{label} drag (forward half only)")
        check_output(dragged, (20000, 3), f"{label} drag")
    launches = counts()  # ---- end of the main path
    full = svc.deform(pts, np.concatenate([surf, tgt * 0.5, handle], -1))
    if not np.allclose(dragged, full, rtol=1e-5, atol=1e-5):
        fail(f"{label}: drag differs from the full deform with the same conditioning")
    for scale in (0.9, 0.8, 0.7, 0.6, 0.4):  # more drags, for a steadier median
        t0 = time.perf_counter()
        session.drag(tgt * scale, handle)
        drag_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"serving {label}: deform "
        f"{', '.join(f'Q={q}: {stats[f'deform_ms_q{q}']:.2f} ms' for q, _ in requests)}")
    log(f"serving {label}: full evaluation at Q=65536 {stats['eval_ms_q65536']:.2f} ms (median of 5,"
        f" {min(eval_ms):.2f}-{max(eval_ms):.2f}), {stats['qps_q65536']:.4g} query points/s")
    log(f"serving {label}: drag at Q=20000 {float(np.median(drag_ms)):.2f} ms (median of 7,"
        f" {min(drag_ms):.2f}-{max(drag_ms):.2f}; first two {drag_ms[0]:.2f}, {drag_ms[1]:.2f})")
    trace(torch, lambda: svc.deform(queries[65536], inputs), stats["eval_ms_q65536"],
          f"one {label} evaluation at Q=65536")
    return svc, launches


def trace(torch, run, wall_ms, what):
    """Device time of one call of ``run`` by kind, from ``torch.profiler``'s
    CUDA activity: the port's kernels (K1 = selection + attention, K2 = the
    attention's backward with its weight-gradient reductions, "frags" = K2's
    weights laid out in fragment order, K3, K4, the row gather), cuBLAS products,
    copies, other PyTorch kernels.  The union of the intervals is
    the device's busy time; against the untraced time ``wall_ms`` it gives
    the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        fail("the profiler recorded no device activity")
    kinds = {"K1": 0.0, "K2": 0.0, "frags": 0.0, "K3": 0.0, "K4": 0.0, "gather": 0.0,
             "cuBLAS": 0.0, "copies": 0.0, "other": 0.0}
    for e in events:
        kind = ("K4" if "knn_points_kernel" in e.name
                else "gather" if "gather_rows_kernel" in e.name
                else "frags" if "weight_frags_kernel" in e.name
                else "K1" if "attn_kernel" in e.name or "knn_kernel" in e.name
                else "K2" if "bwd_rows_kernel" in e.name or "wgrad" in e.name
                else "K3" if "fps_kernel" in e.name
                else "cuBLAS" if "gemm" in e.name
                else "copies" if "Memcpy" in e.name or "Memset" in e.name
                else "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy_us += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy = (busy_us + e0 - s0) / 1e3
    log(f"trace: {what}, {len(events)} device activities, busy {busy:.2f} ms"
        f" ({', '.join(f'{k} {v:.2f}' for k, v in kinds.items())} ms); against the"
        f" {wall_ms:.2f} ms untraced the device idles {100 * (1 - busy / wall_ms):.1f}%")


# ---------------------------------------------------------------- phase 3b

TRAIN_STEPS = 4
# per train step: (K1, K2, K3, K4, gather) launches.  A shipped net runs its
# begin block, 2 set abstraction rounds x 2 levels, 2 transformer_downs and
# its decoder; a pointnet++ net FPS + K4 + gather at 2 levels and (crossatten)
# its decoder.  Runs: (label, model type, configuration (None: shipped)).
TRAIN_LAUNCHES = {"forward": (8, 8, 2, 0, 0), "backward": (8, 8, 2, 0, 0),
                  "arbitrary": (17, 17, 4, 0, 0), "A": (3, 3, 4, 4, 4), "B": (0, 0, 2, 2, 2)}
SHIPPED_RUNS = [("forward", "forward", None), ("backward", "backward", None),
                ("arbitrary", "arbitrary", None)]
ABLATION_RUNS = [("A", "arbitrary", "A"), ("B", "forward", "B")]


def train_batch(rng, B, N, Q, near_surface=False):
    """A batch shaped like ``__graft_entry__._example_batch``: source and
    target surfaces, a handle mask, space samples and their targets.
    ``near_surface`` draws the space samples within ~0.1 of source surface
    points instead of anywhere (the interpolation decoder's weights
    underflow beyond ~2 from every anchor)."""
    surf_src = rng.randn(B, N, 3).astype(np.float32)
    surf_tgt = rng.randn(B, N, 3).astype(np.float32)
    mask = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
    if near_surface:
        pick = rng.randint(0, N, (B, Q))
        space = surf_src[np.arange(B)[:, None], pick] + 0.1 * rng.randn(B, Q, 3)
    else:
        space = rng.randn(B, Q, 3)
    return {
        "surface_samples_inputs": np.concatenate([surf_src, surf_tgt * mask, mask], -1),
        "space_samples_src": space.astype(np.float32),
        "space_samples_tgt": rng.randn(B, Q, 3).astype(np.float32),
    }


def train_setup(torch, model_type, seed, device="cuda", cfg=None):
    """(config, model, schedule, optimizer, steps) of a shipped config or of
    ``cfg``, with seeded random weights."""
    from nsdp_tpu_torch.models import build_model, init_random
    from nsdp_tpu_torch.training import make_steps, optimizer_factory
    from nsdp_tpu_torch.utils.config import load_config

    if cfg is None:
        cfg = load_config(os.path.join(REPO, "configs", "deform4d", f"{model_type}.yaml"))
    model = init_random(build_model(cfg, device=device), seed)
    schedule, opt = optimizer_factory(cfg["training"], model.parameters())
    steps = make_steps(model, model_type, opt, device=device)
    return cfg, model, schedule, opt, steps


def check_resume(torch, rng, model, opt, steps, B, lr, cfg):
    """A checkpoint saved and loaded into a fresh model gives the same
    next loss."""
    import tempfile

    from nsdp_tpu_torch.training import load_checkpoints, save_checkpoints

    with tempfile.TemporaryDirectory() as d:
        save_checkpoints(TRAIN_STEPS, model, opt, d)
        _, model2, _, opt2, steps2 = train_setup(torch, "arbitrary", seed=1, cfg=cfg)
        if load_checkpoints(model2, opt2, d) != TRAIN_STEPS + 1:
            fail("resume did not find the saved epoch")
    for (k, v), v2 in zip(model.state_dict().items(), model2.state_dict().values()):
        if not torch.equal(v, v2):
            fail(f"resume: {k} differs from the saved model")
    nxt = train_batch(rng, B, 5000, 5000)
    l1, l2 = steps["train_step"](nxt, lr), steps2["train_step"](nxt, lr)
    if abs(l1 - l2) > 1e-6 * abs(l1):
        fail(f"resume: the next step's loss {l2} differs from {l1}")
    log(f"train: checkpoint saved and resumed; next stage-2 loss {l1:.6g} and {l2:.6g}")


def train(torch, rng, runs):
    """Full-width training steps on the card (phases 3b and 3d) -> per-run
    stats and the launches of the whole phase.  The stage-2 runs and B are
    also traced; the shipped stage-2 run is resumed from a checkpoint."""
    stats = {}
    reset_counts()  # ---- the main path of training
    for label, model_type, ablation in runs:
        cfg = None if ablation is None else ablation_config(ablation)
        cfg, model, schedule, opt, steps = train_setup(torch, model_type, seed=0, cfg=cfg)
        B = cfg["training"]["batch_size"]
        lr = schedule.get_learning_rate(0)
        near = cfg["model"]["decoder"] == "interp"
        batches = [train_batch(rng, B, 5000, 5000, near) for _ in range(TRAIN_STEPS + 2)]
        before_params = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps["train_step"](batches[0], lr)  # warm-up: cuBLAS and allocator set-up
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        step_ms, losses = [], []
        for batch in batches[1:TRAIN_STEPS + 1]:
            before = counts()
            t0 = time.perf_counter()
            losses.append(steps["train_step"](batch, lr))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            expect_launches(before, TRAIN_LAUNCHES[label], f"{label} train step")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not np.isfinite(losses).all():
            fail(f"{label}: non-finite training loss {losses}")
        moved = max(float((p.detach() - q).abs().max())
                    for p, q in zip(model.parameters(), before_params))
        if not moved > 0:
            fail(f"{label}: the parameters did not move")
        med = float(np.median(step_ms))
        stats[label] = dict(B=B, step_ms=med, peak_gb=peak_gb, losses=losses)
        log(f"train {label:<9} B={B:<3} step {med:.2f} ms (median of {TRAIN_STEPS},"
            f" {min(step_ms):.2f}-{max(step_ms):.2f}; warm-up {warm_ms:.1f}), peak memory"
            f" {peak_gb:.2f} GB, losses {', '.join(f'{x:.4g}' for x in losses)},"
            f" largest parameter move {moved:.3g}")
        if label in ("arbitrary", "A", "B"):
            trace(torch, lambda: steps["train_step"](batches[-1], lr), med,
                  f"one {label} train step (B={B})")
        if label == "arbitrary":
            check_resume(torch, rng, model, opt, steps, B, lr, cfg)
        del model, opt, steps, before_params
        torch.cuda.empty_cache()
    launches = counts()  # ---- end of the main path of training
    return stats, launches


# ---------------------------------------------------------------- phase 4


def rel_err(a, ref) -> float:
    """Relative L2 error ``||a - ref|| / ||ref||``, in float64."""
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm())


def tiny_config(encoder):
    """An 'arbitrary' model at a tiny width, with either encoder."""
    if encoder == "pointransformer":
        enc = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nneighbor_reduced=4,
                   nfinal_transformers=1, d_transformer=16, d_reduced=12, full_SA=True)
    else:
        enc = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nfinal_transformers=1,
                   d_transformer=16)
    return {"model": {
        "type": "arbitrary", "use_normals": False, "encoder": encoder, "encoder_kwargs": enc,
        "decoder": "crossatten",
        "decoder_kwargs": dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3),
    }}


def check_reference(torch, svc, rng, surf, label):
    """The card against the plain path on the CPU (same weights).  Halves
    are compared on identical inputs, so every FPS and kNN selection sees
    the same coordinates on both sides.

    With random weights the BatchNorm statistics do not match the
    activations, and the outputs are O(100): the elementwise tolerance
    then admits errors of ~0.1.  So each half is also held, by relative L2
    error, against the plain path in float64: the card must come as close
    to it as the CPU's own float32 path does, within a factor of 2."""
    from nsdp_tpu_torch.models import build_model, init_random

    state = {k: v.cpu() for k, v in svc.model.state_dict().items()}
    cpu = build_model(svc.config, device="cpu")
    cpu.load_state_dict(state)
    cpu64 = build_model(svc.config, device="cpu").double()
    cpu64.load_state_dict(state)
    pts = rng.uniform(-1.3, 1.3, (1, 1024, 3)).astype(np.float32)
    handle = (surf[:, 2] > 0.8).astype(np.float32)[None, :, None]
    tgt = (surf[None] + 0.2) * handle
    g = lambda a: torch.as_tensor(a, device="cuda")
    c = lambda a: torch.as_tensor(a)
    c64 = lambda a: torch.as_tensor(a).double()
    with torch.inference_mode():
        sc_g, su_g = svc.model.canonicalize(g(pts), g(surf[None]))
        sc_c, su_c = cpu.canonicalize(c(pts), c(surf[None]))
        sc_d, su_d = cpu64.canonicalize(c64(pts), c64(surf[None]))
        sc, su = sc_g.cpu(), su_g.cpu()
        out_g = svc.model.deform(sc_g, su_g, g(tgt), g(handle)).cpu()
        out_c = cpu.deform(sc, su, c(tgt), c(handle))
        out_d = cpu64.deform(sc.double(), su.double(), c64(tgt), c64(handle))
        for what, card, f32, f64 in (("space_cano", sc, sc_c, sc_d),
                                     ("surf_cano", su, su_c, su_d),
                                     ("deform", out_g, out_c, out_d)):
            err, floor = rel_err(card, f64), rel_err(f32, f64)
            worst, worst_f32 = [float((x.double() - f64).abs().max()) for x in (card, f32)]
            log(f"reference {label}: full width {what}: max |output| {float(f64.abs().max()):.4g};"
                f" card vs CPU float32 max abs err {float((card - f32).abs().max()):.3g};"
                f" max abs err against float64: card {worst:.3g}, CPU float32 {worst_f32:.3g};"
                f" relative L2 error against float64: card {err:.3g}, CPU float32 {floor:.3g}")
            # where the float32 path itself errs beyond E2E_TOL against
            # float64 (random weights amplify rounding by the output's
            # scale), the card may instead err at most twice as much
            if not torch.allclose(card, f32, **E2E_TOL) and worst > 2 * worst_f32:
                fail(f"{label} full width {what}: card vs CPU max abs err"
                     f" {float((card - f32).abs().max())}, against float64 {worst:.3g}, more than"
                     f" twice the CPU float32 path's {worst_f32:.3g}")
            if err > max(2 * floor, 1e-6):
                fail(f"{label} full width {what}: the card's relative error {err:.3g} against float64"
                     f" is more than twice the CPU float32 path's {floor:.3g}")

        tiny = tiny_config(svc.config["model"]["encoder"])
        small_g = init_random(build_model(tiny, device="cuda"), 1)
        small_c = init_random(build_model(tiny, device="cpu"), 1)
        inp = np.concatenate([surface(rng, 32), rng.randn(32, 4)], -1).astype(np.float32)[None]
        q = rng.randn(1, 50, 3).astype(np.float32)
        a, b = small_g.predict(g(q), g(inp)).cpu(), small_c.predict(c(q), c(inp))
        if not torch.allclose(a, b, **E2E_TOL):
            fail(f"{label} tiny predict: card vs CPU max abs err {float((a - b).abs().max())}")
    log(f"reference {label}: tiny predict: max |output| {float(b.abs().max()):.4g}; card vs CPU"
        f" max abs err {float((a - b).abs().max()):.3g}, relative L2 error {rel_err(a, b):.3g}")


# ---------------------------------------------------------------- phase 4b


def stage2_step_by_halves(torch, model, batch, device, dtype, cano=None, cot=None):
    """One stage-2 train step's gradients and running statistics, computed
    as the train step does but cut at the canonical pose
    (``FlowArbitrary.canonicalize`` / ``deform``): the deform half runs on
    the canonicalised points ``cano`` and the canonicalize half's backward
    is seeded with the cotangents ``cot`` -- both the card's, given to the
    CPU paths, so every FPS and kNN selection sees the same coordinates on
    every path.  -> (loss, canonicalised points, their gradients)."""
    from nsdp_tpu_torch.training.steps import (
        _batch_norms, _double_bn_update, _snapshot, compute_l2_error)

    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    inputs = t(batch["surface_samples_inputs"])
    model.train()
    model.zero_grad(set_to_none=True)
    bns = _batch_norms(model.model_canonicalize.encoder)
    saved = _snapshot(bns)
    space_cano, surf_cano = model.canonicalize(t(batch["space_samples_src"]), inputs[..., 0:3])
    if cano is None:
        cano = (space_cano.detach(), surf_cano.detach())
    sc, su = [t(c).detach().requires_grad_() for c in cano]
    pred = model.deform(sc, su, inputs[..., 3:6], inputs[..., 6:7])
    loss = compute_l2_error(pred, t(batch["space_samples_tgt"]))
    loss.backward()
    grads = (sc.grad, su.grad)
    torch.autograd.backward([space_cano, surf_cano], [t(c) for c in (cot or grads)])
    _double_bn_update(bns, saved)  # the compound EMA of the stage-2 step
    return float(loss.detach()), cano, grads


def check_training_reference(torch, label, cfg=None, batch_seed=7):
    """One full-width stage-2 train step of the shipped model (or of
    ``cfg``) on the card against the CPU plain path in float32 and float64,
    from the same weights on the same batch, by halves
    (:func:`stage2_step_by_halves`): the loss, the gradients of the
    canonicalised points (what carries the loss into
    ``model_canonicalize``), every parameter's gradient and every running
    statistic after the step."""
    from nsdp_tpu_torch.models import build_model

    cfg, card, _, _, _ = train_setup(torch, "arbitrary", seed=2, cfg=cfg)
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    models = {"card": card}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        models[name] = build_model(cfg, device="cpu").to(dtype)
        models[name].load_state_dict(state)
    # A float32 gradient is discontinuous where a ReLU input or a max-pool
    # candidate sits within rounding of a tie: there the card, the CPU and
    # float64 may each land on another side, and the rule below fails for
    # that reason alone.  The batch seeds given (7 for the shipped model, 19
    # for configuration A) meet no such near-tie on any path; at other seeds
    # single gradients of A err by ~1e-3 (PERF.md, section 6).
    batch = train_batch(np.random.RandomState(batch_seed), 1, 5000, 1024)
    loss, cano, cot = stage2_step_by_halves(torch, card, batch, "cuda", torch.float32)
    cano, cot = [c.cpu() for c in cano], [c.cpu() for c in cot]
    losses, grads = {"card": loss}, {"card": cot}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        losses[name], _, grads[name] = stage2_step_by_halves(
            torch, models[name], batch, "cpu", dtype, cano, cot)
    if abs(losses["card"] - losses["f32"]) > 1e-4 * abs(losses["f32"]):
        fail(f"{label} stage-2 step: card loss {losses['card']} vs CPU float32 {losses['f32']}")
    # Every layer of the step rounds differently on the card (K1, K2,
    # cuBLAS) and on the CPU, so the ratio of two float32 errors spreads
    # wider than at one kernel's inputs (phase 2b), and the ~10^7 ReLU inputs
    # of a step hold a few within rounding of zero, where the gradient jumps:
    # one path may land on the other side (5e-5 relative on a single
    # gradient in this script's runs).  A wrong gradient errs by 1e-2 or more.
    rule = dict(factor=4.0, floor=1e-4)
    for i, what in enumerate(("space_cano", "surf_cano")):
        check_gradient(f"{label} stage-2 step, d {what}", grads["card"][i], grads["f32"][i],
                       grads["f64"][i], **rule)
    params = {name: dict(m.named_parameters()) for name, m in models.items()}
    buffers = {name: dict(m.named_buffers()) for name, m in models.items()}
    worst, n_zero = (0.0, ""), 0
    for key, p in params["card"].items():
        weight = params["f64"].get(key[:-4] + "weight") if key.endswith(".bias") else None
        ratio = check_gradient(f"{label} stage-2 step, d {key}", p.grad.cpu(),
                               params["f32"][key].grad,
                               params["f64"][key].grad, None if weight is None else weight.grad,
                               **rule)
        n_zero += ratio is None
        worst = max(worst, (ratio or 0.0, key))
    n_stats = 0
    for key, b in buffers["card"].items():
        if key.endswith(("running_mean", "running_var")):
            n_stats += 1
            check_gradient(f"{label} stage-2 step, {key}", b.cpu(), buffers["f32"][key],
                           buffers["f64"][key], **rule)
    log(f"reference {label}: full-width stage-2 step (B=1, N=5000, Q=1024): loss card"
        f" {losses['card']:.7g},"
        f" CPU float32 {losses['f32']:.7g}, float64 {losses['f64']:.7g}; d space_cano and"
        f" d surf_cano, {len(params['card'])} parameter gradients ({n_zero} analytically zero,"
        f" held absolutely) and {n_stats} running statistics within the rule; largest ratio of"
        f" the card's error to the CPU float32 path's {worst[0]:.3g} ({worst[1]})")

def short_name(mangled: str) -> str:
    """``attn_kernel<4>`` from a mangled kernel name."""
    m = re.search(r"\d+([A-Za-z_]+?_kernel)(ILi(\d+)E)?", mangled)
    return mangled if m is None else m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")


# kernels whose products run on the tensor cores (K2)
TENSOR_CORE_KERNELS = ("bwd_rows_kernel", "wgrad_kernel")


def report_build(build) -> None:
    """Phase 1's build lines: per kernel, ptxas's registers, shared memory
    and spills, and the count of tensor-core (HMMA) instructions in the
    library's SASS (``cuobjdump --dump-sass``); fails if a kernel of
    ``TENSOR_CORE_KERNELS`` has none."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in build.SOURCES:
        fn = "?"
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = short_name(line.split("'")[1])
            elif "Used" in line or "spill" in line:
                log(f"  {name}: {fn}: {line.strip()}")
        sass = subprocess.run([cuobjdump, "--dump-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hmma, fn = {}, None
        for line in sass.splitlines():
            if "Function : " in line:
                fn = short_name(line.split("Function : ")[1].strip())
                hmma[fn] = 0
            elif fn is not None and "HMMA" in line:
                hmma[fn] += 1
        log(f"  {name}: HMMA instructions by kernel: "
            + ", ".join(f"{k} {v}" for k, v in sorted(hmma.items())))
        for fn, n in hmma.items():
            if fn.split("<")[0] in TENSOR_CORE_KERNELS and n == 0:
                fail(f"{fn} has no tensor-core instruction")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(REPO, "nsdp_tpu_torch")) or not os.path.exists(CONFIG):
        fail("run from a checkout of the repository: nsdp_tpu_torch/ and configs/ are missing")
    sys.path.insert(0, REPO)
    from nsdp_tpu_torch.ops import _build
    from nsdp_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    report_build(_build)

    rng = np.random.RandomState(0)
    surf = surface(rng, 5000)
    rows = check_kernels(torch, rng, surf)
    rows["k4"] = check_knn(torch, rng, surf)
    rows["gather"] = check_gather(torch, rng, surf)
    rows["k2"] = check_backward(torch, rng, surf, *rows.pop("fps"))
    svc, launches = serve(torch, rng, surf, load_config(CONFIG), "shipped")
    check_reference(torch, svc, rng, surf, "shipped")
    del svc
    torch.cuda.empty_cache()
    _, train_launches = train(torch, rng, SHIPPED_RUNS)
    check_training_reference(torch, "shipped")
    svc, ablation_launches = serve(torch, rng, surf, ablation_config("A"), "A")
    check_reference(torch, svc, rng, surf, "A")
    del svc
    torch.cuda.empty_cache()
    train(torch, rng, ABLATION_RUNS)
    check_training_reference(torch, "A", ablation_config("A"), batch_seed=19)

    kernels = [
        kernel_entry("fused_knn_vector_attention", "nsdp_tpu_torch/csrc/attention.cu",
                     "nsdp_tpu/ops/attention_pallas.py:134", rows["k1"], launches[0]),
        kernel_entry("fused_knn_vector_attention_backward", "nsdp_tpu_torch/csrc/attention_bwd.cu",
                     "nsdp_tpu/ops/attention_pallas.py:292", rows["k2"], train_launches[1]),
        kernel_entry("furthest_point_sample", "nsdp_tpu_torch/csrc/fps.cu",
                     "nsdp_tpu/ops/fps_pallas.py:32", rows["k3"], launches[2]),
        kernel_entry("knn", "nsdp_tpu_torch/csrc/knn.cu",
                     "nsdp_tpu/ops/knn_pallas.py:30", rows["k4"], ablation_launches[3]),
        kernel_entry("row_gather", "nsdp_tpu_torch/csrc/gather.cu",
                     "scripts/bench_gather_prefetch.py:42 and scripts/bench_gather_prefetch.py:83",
                     rows["gather"], ablation_launches[4]),
    ]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was never launched on the main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
