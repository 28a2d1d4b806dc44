"""Each cell's comparison, driven through a whole run on the CPU at tiny
sizes (the look for a card skipped), comes out correct on the program as
it is and not correct with each fault the cell can have planted in its
timed path: an answer altered where it is produced (serving, drags; in
serving also on every other call alone), a step that leaves the state
unchanged, half of the batch left out with the mean taken over the rest
(training, in the steps after set-up's first replay).  One card: no exchange between
cards to leave out."""

import pytest

from nsdp_bench.tests import tiny

CASES = [
    ("arbitrary-serve-q65536", None, True), ("arbitrary-serve-q65536", "answer", False),
    ("arbitrary-serve-q65536", "answer_alternate", False),
    ("arbitrary-drag-sessions", None, True), ("arbitrary-drag-sessions", "answer", False),
    ("pointnet2-train-stage2-b8", None, True), ("pointnet2-train-stage2-b8", "unchanged", False),
    ("pointnet2-train-stage2-b8", "half_batch", False),
    ("arbitrary-train-stage2-b8", None, True), ("arbitrary-train-stage2-b8", "unchanged", False),
    ("arbitrary-train-stage2-b8", "half_batch", False),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell,fault,correct", CASES)
def test_fault_is_caught(root, cell, fault, correct):
    result = tiny.run(root, cell, seed=9, fault=fault)
    assert result["correct"] is correct, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
