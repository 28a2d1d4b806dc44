"""The benchmark's inputs, drawn from ``--seed`` and a traffic file.

One generator reads every traffic file (``traffic/<name>.json``).  Shapes
are closed blobby surfaces around the origin (every point an FPS
candidate, ``|p|^2 ~ 1``), each with its own axes, harmonic and rotation;
a handle is the contiguous region of the surface nearest a random surface
point, moved by a translation of at most ``max_shift``.  The conditioning
of a request is [source xyz | target xyz * handle | handle] (N, 7), as the
published datasets give it.

Sizes come from a ``{"low": a, "high": b, "dist": "fixed" | "uniform" |
"loguniform"}`` entry (or a plain number).  A seed draws the shapes and the
order of the sizes, never the sizes themselves: the sizes of a pool are
the pool's quantiles of the distribution, so every seed gives a run the
same work in another order.
"""

import math
from typing import Dict, List, Union

import numpy as np

Size = Union[int, Dict]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and a stream of sub-keys."""
    return np.random.default_rng([int(seed) % 2 ** 63, *stream])


def sizes(spec: Size, n: int) -> List[int]:
    """n sizes of ``spec``: its quantiles at (i + 1/2) / n, ascending."""
    if isinstance(spec, (int, float)):
        return [int(spec)] * n
    lo, hi, dist = int(spec["low"]), int(spec["high"]), spec.get("dist", "uniform")
    qs = [(i + 0.5) / n for i in range(n)]
    if dist == "fixed" or lo == hi:
        return [lo] * n
    if dist == "uniform":
        return [int(round(lo + q * (hi - lo))) for q in qs]
    if dist == "loguniform":
        return [int(round(math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo))))) for q in qs]
    raise ValueError(f"unknown size distribution {dist!r}")


class Shape:
    """A closed blobby surface: unit directions scaled by ``1 + a sin(f
    theta) cos(g phi)`` and by per-axis scales, then rotated."""

    def __init__(self, rng: np.random.Generator):
        self.axes = rng.uniform(0.7, 1.3, 3)
        self.amp = rng.uniform(0.1, 0.3)
        self.f, self.g = rng.integers(2, 5, 2)
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        self.rot = q * np.sign(np.diag(r))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        v = rng.standard_normal((n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        theta, phi = np.arccos(np.clip(v[:, 2], -1, 1)), np.arctan2(v[:, 1], v[:, 0])
        r = 1.0 + self.amp * np.sin(self.f * theta) * np.cos(self.g * phi)
        return ((v * r[:, None] * self.axes) @ self.rot.T).astype(np.float32)


def handle(rng: np.random.Generator, surf: np.ndarray, share: float):
    """-> ((N,) float32 mask of the ``share`` of surface points nearest a
    random surface point, a contiguous region; that point)."""
    centre = surf[rng.integers(len(surf))]
    d2 = ((surf - centre) ** 2).sum(-1)
    n = max(1, int(round(share * len(surf))))
    mask = np.zeros(len(surf), np.float32)
    mask[np.argsort(d2, kind="stable")[:n]] = 1.0
    return mask, centre


def shift(rng: np.random.Generator, max_shift: float) -> np.ndarray:
    """A translation of length up to ``max_shift`` in a random direction."""
    v = rng.standard_normal(3)
    return (v / np.linalg.norm(v) * rng.uniform(0.5, 1.0) * max_shift).astype(np.float32)


def conditioning(src: np.ndarray, tgt: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[source | target * mask | mask] (N, 7) float32."""
    m = mask[:, None]
    return np.concatenate([src, tgt * m, m], axis=1).astype(np.float32)


def box(rng: np.random.Generator, surf: np.ndarray, n: int, margin: float) -> np.ndarray:
    """n points uniform in the surface's bounding box grown by ``margin``
    of its size on each side."""
    lo, hi = surf.min(0), surf.max(0)
    pad = margin * (hi - lo)
    return rng.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)


def requests(traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool of ``deform`` requests: ``points`` (Q, 3) in the shape's
    box and ``inputs`` (N, 7)."""
    pool = traffic["pool"]
    qs = sizes(traffic["queries"], pool)
    order = rng_for(seed, 0).permutation(pool)
    out = []
    for i in range(pool):
        rng = rng_for(seed, 1, i)
        shape = Shape(rng)
        src = shape.sample(rng, traffic["surface_points"])
        mask, _ = handle(rng, src, traffic["handle_share"])
        tgt = src + shift(rng, traffic["max_shift"])
        out.append({"points": box(rng, src, qs[order[i]], traffic["box_margin"]),
                    "inputs": conditioning(src, tgt, mask)})
    return out


def sessions(traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool of edit sessions: ``points`` (Q, 3) on the shape,
    ``surface`` (N, 3), ``mask`` (N, 1) and ``targets`` (drags, N, 3): the
    masked target of each drag along a straight path to the final shift."""
    pool, drags = traffic["pool"], traffic["drags"]
    qs = sizes(traffic["queries"], pool)
    order = rng_for(seed, 0).permutation(pool)
    out = []
    for i in range(pool):
        rng = rng_for(seed, 1, i)
        shape = Shape(rng)
        src = shape.sample(rng, traffic["surface_points"])
        mask, _ = handle(rng, src, traffic["handle_share"])
        final = shift(rng, traffic["max_shift"])
        steps = np.arange(1, drags + 1, dtype=np.float32)[:, None, None] / drags
        targets = (src[None] + steps * final) * mask[None, :, None]
        out.append({"points": shape.sample(rng, qs[order[i]]), "surface": src,
                    "mask": mask[:, None], "targets": targets.astype(np.float32)})
    return out


def batches(traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool of training batches: ``surface_samples_inputs`` (B, N, 7),
    ``space_samples_src`` / ``space_samples_tgt`` (B, Q, 3).  Each item's
    space samples lie in its shape's box, and its target is a smooth
    deformation: the handle's shift, fading with the distance to the
    handle's centre (a Gaussian of width ``falloff``)."""
    B, N, Q = traffic["batch"], traffic["surface_points"], traffic["space_points"]
    out = []
    for i in range(traffic["pool"]):
        items = {"surface_samples_inputs": [], "space_samples_src": [], "space_samples_tgt": []}
        for b in range(B):
            rng = rng_for(seed, 2, i, b)
            shape = Shape(rng)
            src = shape.sample(rng, N)
            mask, centre = handle(rng, src, traffic["handle_share"])
            t = shift(rng, traffic["max_shift"])
            space = box(rng, src, Q, traffic["box_margin"])
            d2 = ((space - centre) ** 2).sum(-1, keepdims=True)
            w = np.exp(-d2 / traffic["falloff"] ** 2).astype(np.float32)
            items["surface_samples_inputs"].append(conditioning(src, src + t, mask))
            items["space_samples_src"].append(space)
            items["space_samples_tgt"].append(space + w * t)
        out.append({k: np.stack(v).astype(np.float32) for k, v in items.items()})
    return out

