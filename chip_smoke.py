#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nsdp_tpu_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero and prints no result line):

1. setup: TF32 off, the card's name and power limit, the CUDA kernels built
   from ``nsdp_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernels: each hand-written kernel held against its plain PyTorch version
   at every shape the main path gives it -- fused kNN attention (K1) within
   rtol 1e-4 / atol 1e-5, furthest-point sampling (K3) index for index --
   and timed beside it (CUDA events, median);
3. serving: the shipped full-width ``configs/deform4d/arbitrary.yaml``
   model with seeded random weights warms up (``warmup``), then serves
   three ``deform`` requests (Q = 3000, 20000 masked, 65536) and an edit
   session with two drags; the launch counters must show 17 K1 and 4 K3
   launches per full evaluation and 8 + 2 per drag (the forward half only);
   then one evaluation is traced with ``torch.profiler``: device time by
   kind and the device's idle share;
4. reference: the card's canonicalize and deform halves against the plain
   PyTorch path on the CPU, at full width on a small query set (within
   rtol 1e-3 / atol 2e-4 of the float32 path, and as close to the float64
   path, by relative L2 error, as the float32 path within a factor of 2),
   and the whole predict at a tiny width.

The second-to-last lines are the card (``nvidia-smi``) and a ``kernels``
JSON object; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "deform4d", "arbitrary.yaml")
# H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate (700 W part)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
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


def bound(flops: float, nbytes: float):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def surface(rng, n: int) -> np.ndarray:
    """A closed blobby surface around the origin (every point is an FPS
    candidate: |p|^2 ~ 1)."""
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta, phi = np.arccos(v[:, 2]), np.arctan2(v[:, 1], v[:, 0])
    r = 1.0 + 0.25 * np.sin(3 * theta) * np.cos(2 * phi)
    return (v * r[:, None] * np.array([1.0, 0.7, 1.3])).astype(np.float32)


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


def k1_inputs(torch, rng, surf, fps_500, fps_100, site):
    name, _, nq, m, k, d, mode, masked = site
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
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
    args = dict(xyz_q=t(xyz_q[None]), kv_xyz=t(kv[None]), q_feats=None, K_a=None,
                V_a=None, weights=weights, k=k)
    if mode != "pos_only":
        args["K_a"], args["V_a"] = t(rng.randn(1, m, d)), t(rng.randn(1, m, d))
        if mode == "global":  # the decoder's query is one broadcast row
            args["q_feats"] = t(rng.randn(1, 1, d)).expand(1, nq, d)
            args["k_glob"], args["v_glob"] = t(rng.randn(1, d)), t(rng.randn(1, d))
        else:
            args["q_feats"] = t(rng.randn(1, nq, d))
    if masked:
        mask = np.ones((1, m), np.float32)
        mask[:, -m // 10:] = 0.0
        args["kv_mask"] = t(mask)
    return args


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

    rows = {"k1": [], "k3": []}
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
        flops, nbytes = k1_work(site)
        rows["k1"].append(dict(site=site[0], per_eval=site[1], Nq=site[2], M=site[3],
                               k=site[4], D=site[5], ms=ms, plain_ms=plain_ms,
                               max_abs_err=err, flops=flops, bytes=nbytes))
        log(f"K1 {site[0]:<26} Nq={site[2]:<6} M={site[3]:<5} k={site[4]:<3} D={site[5]:<4}"
            f" kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound(flops, nbytes)[0]:.4f} ms"
            f" ({bound(flops, nbytes)[1]})  max_abs_err {err:.3g}")

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


def kernel_entry(name, source, replaces, rows, launches):
    """One kernel's entry of the ``kernels`` line: times and bounds summed
    over the launches of one full evaluation."""
    ms = sum(r["ms"] * r["per_eval"] for r in rows)
    plain_ms = sum(r["plain_ms"] * r["per_eval"] for r in rows)
    t_ops = sum(r["flops"] * r["per_eval"] for r in rows) / PEAK_F32_FLOPS * 1e3
    t_bytes = sum(r["bytes"] * r["per_eval"] for r in rows) / PEAK_BYTES * 1e3
    bound_ms = sum(bound(r["flops"], r["bytes"])[0] * r["per_eval"] for r in rows)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
    }


# ---------------------------------------------------------------- phase 3


def counts():
    from nsdp_tpu_torch.ops import attention, fps

    return attention.fused_vector_attention.launches, fps.furthest_point_sample.launches


def reset_counts():
    from nsdp_tpu_torch.ops import attention, fps

    attention.fused_vector_attention.launches = 0
    fps.furthest_point_sample.launches = 0


def expect_launches(before, want, what):
    got = tuple(a - b for a, b in zip(counts(), before))
    if got != want:
        fail(f"{what}: {got[0]} K1 / {got[1]} K3 launches, expected {want[0]} / {want[1]}")


def check_output(out, shape, what):
    if out.shape != shape or not np.isfinite(out).all():
        fail(f"{what}: output {out.shape} (finite: {np.isfinite(out).all()}), expected {shape}")


def serve(torch, rng, surf):
    from nsdp_tpu_torch.serving import DeformationService

    svc = DeformationService.from_config(CONFIG, device="cuda", seed=0)
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
    log(f"serving: warmup (3 buckets, plain + masked + edit session) {time.perf_counter() - t0:.2f} s")

    stats = {}
    reset_counts()  # ---- the main path: requests, a session, two drags
    for q, mask in requests:
        inp = inputs if mask is None else inputs * mask[:, None]
        before = counts()
        t0 = time.perf_counter()
        out = svc.deform(queries[q], inp, point_mask=mask)
        dt = time.perf_counter() - t0
        expect_launches(before, (17, 4), f"deform Q={q}")
        check_output(out, (q, 3), f"deform Q={q}")
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
    expect_launches(before, (9, 2), "edit_session")
    drag_ms = []
    for scale in (1.0, 0.5):
        before = counts()
        t0 = time.perf_counter()
        dragged = session.drag(tgt * scale, handle)
        drag_ms.append((time.perf_counter() - t0) * 1e3)
        expect_launches(before, (8, 2), "drag (forward half only)")
        check_output(dragged, (20000, 3), "drag")
    launches = counts()  # ---- end of the main path
    full = svc.deform(pts, np.concatenate([surf, tgt * 0.5, handle], -1))
    if not np.allclose(dragged, full, rtol=1e-5, atol=1e-5):
        fail("drag differs from the full deform with the same conditioning")
    for scale in (0.9, 0.8, 0.7, 0.6, 0.4):  # more drags, for a steadier median
        t0 = time.perf_counter()
        session.drag(tgt * scale, handle)
        drag_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"serving: deform {', '.join(f'Q={q}: {stats[f'deform_ms_q{q}']:.2f} ms' for q, _ in requests)}")
    log(f"serving: full evaluation at Q=65536 {stats['eval_ms_q65536']:.2f} ms (median of 5,"
        f" {min(eval_ms):.2f}-{max(eval_ms):.2f}), {stats['qps_q65536']:.4g} query points/s")
    log(f"serving: drag at Q=20000 {float(np.median(drag_ms)):.2f} ms (median of 7,"
        f" {min(drag_ms):.2f}-{max(drag_ms):.2f}; first two {drag_ms[0]:.2f}, {drag_ms[1]:.2f})")
    trace_evaluation(torch, svc, queries[65536], inputs, stats["eval_ms_q65536"])
    return svc, launches


def trace_evaluation(torch, svc, pts, inputs, eval_ms):
    """Device time of one evaluation by kind, from ``torch.profiler``'s CUDA
    activity: the port's kernels (K1 = selection + attention, K3), cuBLAS
    products, copies, other PyTorch kernels.  The union of the intervals is
    the device's busy time; against the untraced evaluation time it gives
    the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.deform(pts, inputs)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        fail("the profiler recorded no device activity")
    kinds = {"K1": 0.0, "K3": 0.0, "cuBLAS": 0.0, "copies": 0.0, "other": 0.0}
    for e in events:
        kind = ("K1" if "attn_kernel" in e.name or "knn_kernel" in e.name
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
    log(f"trace: one evaluation at Q=65536, {len(events)} device activities, busy {busy:.2f} ms"
        f" ({', '.join(f'{k} {v:.2f}' for k, v in kinds.items())} ms); against the"
        f" {eval_ms:.2f} ms evaluation the device idles {100 * (1 - busy / eval_ms):.1f}%")


# ---------------------------------------------------------------- phase 4


def rel_err(a, ref) -> float:
    """Relative L2 error ``||a - ref|| / ||ref||``, in float64."""
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm())


def check_reference(torch, svc, rng, surf):
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
            log(f"reference: full width {what}: max |output| {float(f64.abs().max()):.4g};"
                f" card vs CPU float32 max abs err {float((card - f32).abs().max()):.3g};"
                f" relative L2 error against float64: card {err:.3g}, CPU float32 {floor:.3g}")
            if not torch.allclose(card, f32, **E2E_TOL):
                fail(f"full width {what}: card vs CPU max abs err {float((card - f32).abs().max())}")
            if err > max(2 * floor, 1e-6):
                fail(f"full width {what}: the card's relative error {err:.3g} against float64"
                     f" is more than twice the CPU float32 path's {floor:.3g}")

        tiny = {"model": {
            "type": "arbitrary", "use_normals": False, "encoder": "pointransformer",
            "encoder_kwargs": dict(npoints_per_layer=[32, 16, 8], nneighbor=6,
                                   nneighbor_reduced=4, nfinal_transformers=1,
                                   d_transformer=16, d_reduced=12, full_SA=True),
            "decoder": "crossatten",
            "decoder_kwargs": dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3),
        }}
        small_g = init_random(build_model(tiny, device="cuda"), 1)
        small_c = init_random(build_model(tiny, device="cpu"), 1)
        inp = np.concatenate([surface(rng, 32), rng.randn(32, 4)], -1).astype(np.float32)[None]
        q = rng.randn(1, 50, 3).astype(np.float32)
        a, b = small_g.predict(g(q), g(inp)).cpu(), small_c.predict(c(q), c(inp))
        if not torch.allclose(a, b, **E2E_TOL):
            fail(f"tiny predict: card vs CPU max abs err {float((a - b).abs().max())}")
    log(f"reference: tiny predict: max |output| {float(b.abs().max()):.4g}; card vs CPU"
        f" max abs err {float((a - b).abs().max()):.3g}, relative L2 error {rel_err(a, b):.3g}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(REPO, "nsdp_tpu_torch")) or not os.path.exists(CONFIG):
        fail("run from a checkout of the repository: nsdp_tpu_torch/ and configs/ are missing")
    sys.path.insert(0, REPO)
    from nsdp_tpu_torch.ops import _build

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
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.RandomState(0)
    surf = surface(rng, 5000)
    rows = check_kernels(torch, rng, surf)
    svc, launches = serve(torch, rng, surf)
    check_reference(torch, svc, rng, surf)

    kernels = [
        kernel_entry("fused_knn_vector_attention", "nsdp_tpu_torch/csrc/attention.cu",
                     "nsdp_tpu/ops/attention_pallas.py:134", rows["k1"], launches[0]),
        kernel_entry("furthest_point_sample", "nsdp_tpu_torch/csrc/fps.cu",
                     "nsdp_tpu/ops/fps_pallas.py:32", rows["k3"], launches[1]),
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
