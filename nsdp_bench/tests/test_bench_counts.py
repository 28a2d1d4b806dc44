"""The operation counts, worked out on the reference on the ``meta``
device, against the numbers behind ``PERF.md``'s kernel table: the
sum over an evaluation's attention calls of ``chip_smoke.py``'s
``k1_work`` and ``bound_tc`` (17 sites at Q = 65,536), of a stage-2 step's
``k2_work`` (17 sites at B = 8), and ``nsdp_tpu_torch.bench``'s
``flops_per_eval`` (PR 16: 381,818,210,944 at Q = 65,536), pinned here as
numbers."""

import json
from collections import Counter

import pytest

from nsdp_bench import counts
from nsdp_bench.tests.tiny import BENCH


def model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


def test_evaluation_counts_are_the_kernel_tables():
    ev = counts.evaluation(model("nsdp-arbitrary"), 5000, 65536)
    assert ev["flops"] == 381_818_210_944.0
    assert Counter(ev["sites"]) == Counter({
        (1, 5000, 5000, 10, 120, "pos_only"): 1, (1, 5000, 5000, 10, 120, "featured"): 1,
        (1, 500, 5000, 16, 120, "featured"): 4, (1, 500, 500, 16, 120, "featured"): 2,
        (1, 100, 500, 16, 256, "featured"): 4, (1, 100, 100, 16, 256, "featured"): 2,
        (1, 65536, 100, 7, 200, "global"): 2, (1, 5000, 100, 7, 200, "global"): 1})
    assert sum(counts.k1_work(s)[0] for s in ev["sites"]) == 250_264_544_000.0
    assert sum(counts.k1_work(s)[1] for s in ev["sites"]) == 159_944_944.0
    assert counts.k1_least_ms(ev["sites"]) == pytest.approx(1.5619742584531886, rel=1e-12)


def test_train_step_counts_are_the_kernel_tables():
    st = counts.train_step(model("nsdp-arbitrary"), 8, 5000, 5000)
    assert len(st["sites"]) == 17
    assert sum(counts.k2_work(s)[0] for s in st["sites"]) == 1_073_799_398_400.0
    assert sum(counts.k2_work(s)[1] for s in st["sites"]) == 736_932_160.0
    assert counts.k2_least_ms(st["sites"]) == pytest.approx(6.631180789579376, rel=1e-12)
    assert st["flops"] == 1_943_669_670_912.0


def test_pointnet2_counts():
    """The ablation runs K1 and K2 only in its decoders: 3 sites."""
    ev = counts.evaluation(model("nsdp-pointnet2-arbitrary"), 5000, 65536)
    assert Counter(ev["sites"]) == Counter({(1, 65536, 100, 7, 200, "global"): 2,
                                            (1, 5000, 100, 7, 200, "global"): 1})
    st = counts.train_step(model("nsdp-pointnet2-arbitrary"), 8, 5000, 5000)
    assert Counter(st["sites"]) == Counter({(8, 5000, 100, 7, 200, "global"): 3})
    assert st["flops"] == 1_615_790_656_512.0


def test_counts_read_valid_rows_only():
    """A drag's count follows the valid queries, not a bucket."""
    a = counts.drag(model("nsdp-arbitrary"), 5000, 20000)
    b = counts.drag(model("nsdp-arbitrary"), 5000, 40000)
    assert len(a["sites"]) == 8 and a["flops"] < b["flops"]
