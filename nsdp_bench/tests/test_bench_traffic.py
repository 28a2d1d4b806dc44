"""The traffic from a seed: the same seed gives the same inputs byte for
byte, another seed other inputs, and every seed the same sizes."""

import json

import numpy as np
import pytest

from nsdp_bench.tests.tiny import BENCH, TINY_TRAFFIC
from nsdp_bench.traffic import generate

MAKERS = {"serve": generate.requests, "drag": generate.sessions, "train": generate.batches}


def traffic(name):
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    return dict(t, **TINY_TRAFFIC[t["entry"]])


def flat(items):
    return b"".join(np.ascontiguousarray(v).tobytes() for it in items for _, v in sorted(it.items()))


@pytest.mark.parametrize("name", ["serve-q65536", "drag-sessions", "train-stage2-b8"])
def test_seed_decides_the_inputs(name):
    t = traffic(name)
    make = MAKERS[t["entry"]]
    big = 2 ** 31 + 12345
    assert flat(make(t, big)) == flat(make(t, big))
    assert flat(make(t, big)) != flat(make(t, big + 1))
    if "queries" in t:
        shape = lambda s: sorted(len(it["points"]) for it in make(t, s))
        assert shape(big) == shape(7) == sorted(generate.sizes(t["queries"], t["pool"]))


def test_sizes_are_quantiles():
    assert generate.sizes({"low": 10242, "high": 40962, "dist": "uniform"}, 16)[0] == 11202
    assert generate.sizes(65536, 3) == [65536] * 3
    q = generate.sizes({"low": 2000, "high": 65536, "dist": "loguniform"}, 8)
    assert q == sorted(q) and 2000 < q[0] and q[-1] < 65536


def test_requests_are_shapes_with_handles():
    t = dict(pool=2, surface_points=500, queries=1000, handle_share=0.15, max_shift=0.3,
             box_margin=0.1)
    for r in generate.requests(t, 3):
        inp = r["inputs"]
        mask = inp[:, 6]
        assert inp.shape == (500, 7) and r["points"].shape == (1000, 3)
        assert mask.sum() == 75 and np.all(inp[mask == 0, 3:6] == 0)
        shift = inp[mask > 0, 3:6] - inp[mask > 0, 0:3]
        assert np.allclose(shift, shift[0], atol=1e-6) and np.linalg.norm(shift[0]) <= 0.3 + 1e-6
        assert ((inp[:, :3] ** 2).sum(1) > 1e-3).all()  # every point an FPS candidate
