"""Operations, bytes and least times of the work a request or a step needs,
from its shapes alone.

The attention sites come from the benchmark's own reference, run on the
``meta`` device (no memory, no arithmetic) with ``Reference.record`` set;
the model's matrix-product operations are ``torch.utils.flop_counter``'s
count over the same run.  The per-site formulas are frozen copies of the
ones behind ``PERF.md``'s kernel table (``chip_smoke.py``'s ``k1_work``,
``k1_mm_flops``, ``k2_work``, ``k2_mm_flops``, ``bound_tc``; the flop count
of ``nsdp_tpu_torch/bench.py``'s ``flops_per_eval``), for a site of batch B
(weights read once).  Counts are of the valid rows, never of padding.

Peaks: one NVIDIA H100 SXM (data sheet, dense, 700 W): float32 outside the
tensor cores 67 TFLOP/s, float32-accurate products on the tensor cores in
3xTF32 495 / 3 = 165 TFLOP/s, HBM3 3.35 TB/s.
"""

from typing import Dict, Iterable, List, Tuple

import torch

from nsdp_bench.reference.model import Reference, l2_loss, parameter_spec

PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12

Site = Tuple[int, int, int, int, int, str]  # (B, Nq, M, k, D, mode)


def k1_mm_flops(site: Site) -> float:
    """The forward attention's D x D products: three per neighbour slot,
    two for the global slot once per batch item."""
    B, nq, m, k, d, mode = site
    return float(B * (nq * k * 6 * d * d + (4 * d * d if mode == "global" else 0)))


def k1_work(site: Site) -> Tuple[float, float]:
    """(flops, bytes) the forward attention must do and move."""
    B, nq, m, k, d, mode = site
    glob = mode == "global"
    per_query = 9 * m + k * (6 * d * d + 20 * d) + (8 * d if glob else 0)
    floats = B * (nq * 3 + m * 3 + nq * d)  # queries, kv points, output
    floats += 3 * d + 4 * d + 3 * d * d  # fc_delta, fc_gamma
    if mode != "pos_only":
        floats += B * (2 * m * d + (d if glob else nq * d))  # K, V, q (one row if broadcast)
    floats += B * 2 * d if glob else 0
    return float(B * (nq * per_query + (4 * d * d + 4 * d if glob else 0))), float(4 * floats)


def k2_mm_flops(site: Site) -> float:
    """The backward's D x D products: per neighbour row three recomputed,
    three input-gradient and three weight-gradient products (18 D^2), per
    global-slot row 12 D^2."""
    B, nq, m, k, d, mode = site
    return float(B * nq * (k * 18 * d * d + (12 * d * d if mode == "global" else 0)))


def k2_work(site: Site) -> Tuple[float, float]:
    """(flops, bytes) the backward must do and move."""
    B, nq, m, k, d, mode = site
    glob = mode == "global"
    flops = B * nq * (k * (18 * d * d + 40 * d) + (12 * d * d + 30 * d if glob else 0))
    floats = B * (2 * nq * 3 + 2 * m * 3 + nq * k + nq * d)  # coords and their grads, idx, g
    if mode != "pos_only":
        floats += B * (4 * m * d + (2 * d if glob else 2 * nq * d))  # K, V, q and their grads
    floats += B * 4 * d if glob else 0
    floats += 2 * (3 * d * d + 7 * d)  # weights and their gradients
    return float(flops), float(4 * floats)


def least_ms(flops: float, mm_flops: float, nbytes: float) -> float:
    """Least time in ms: the D x D products at the 3xTF32 tensor-core
    rate, the rest of the operations at the float32 rate, or the bytes,
    whichever is longer (``bound_tc``)."""
    t_ops = mm_flops / PEAK_3XTF32_FLOPS + (flops - mm_flops) / PEAK_F32_FLOPS
    return max(t_ops, nbytes / PEAK_BYTES) * 1e3


def k1_least_ms(sites: Iterable[Site]) -> float:
    return sum(least_ms(k1_work(s)[0], k1_mm_flops(s), k1_work(s)[1]) for s in sites)


def k2_least_ms(sites: Iterable[Site]) -> float:
    return sum(least_ms(k2_work(s)[0], k2_mm_flops(s), k2_work(s)[1]) for s in sites)


def _meta_model(model_cfg: Dict) -> Tuple[Reference, List[str]]:
    params = {}
    trainable = []
    for name, shape, kind in parameter_spec(model_cfg):
        dtype = torch.long if kind == "count" else torch.float32
        params[name] = torch.empty(shape, dtype=dtype, device="meta")
        if kind in ("weight", "bias", "bn_weight", "bn_bias"):
            trainable.append(name)
    return Reference(model_cfg, params), trainable


def evaluation(model_cfg: Dict, n_surface: int, n_queries: int) -> Dict:
    """One evaluation (``predict``: canonicalise, then deform) of
    ``n_queries`` points on ``n_surface`` conditioning points: ``sites``
    (its attention calls), ``flops`` (its matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    ref, _ = _meta_model(model_cfg)
    ref.record = True
    pts = torch.empty((1, n_queries, 3), device="meta")
    inp = torch.empty((1, n_surface, 7), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.predict(pts, inp, twice=False)
    return {"sites": list(ref.sites), "flops": float(counter.get_total_flops())}


def drag(model_cfg: Dict, n_surface: int, n_queries: int) -> Dict:
    """One drag (the forward half, ``deform``) of ``n_queries`` points."""
    from torch.utils.flop_counter import FlopCounterMode

    ref, _ = _meta_model(model_cfg)
    ref.record = True
    pts = torch.empty((1, n_queries, 3), device="meta")
    surf = torch.empty((1, n_surface, 3), device="meta")
    mask = torch.empty((1, n_surface, 1), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.deform(pts, surf, surf, mask)
    return {"sites": list(ref.sites), "flops": float(counter.get_total_flops())}


def train_step(model_cfg: Dict, B: int, n_surface: int, n_queries: int) -> Dict:
    """One stage-2 train step (forward, loss, backward; the surface
    encoded once): ``sites`` (its forward attention calls, each with a
    backward), ``flops`` (matrix products of the forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    ref, trainable = _meta_model(model_cfg)
    ref.train()
    ref.record = True
    for name in trainable:
        ref.p[name].requires_grad_()
    pts = torch.empty((B, n_queries, 3), device="meta")
    inp = torch.empty((B, n_surface, 7), device="meta")
    with FlopCounterMode(display=False) as counter:
        loss = l2_loss(ref.predict(pts, inp, twice=False), pts)
        torch.autograd.grad(loss, [ref.p[n] for n in trainable])
    return {"sites": list(ref.sites), "flops": float(counter.get_total_flops())}
