"""The tiny checkout's sizes for the entry ``train_stage1``
(``tests/tiny.py``): ``train``'s, the forward net's steps on the same
tiny batches."""

from nsdp_bench.tests import tiny

tiny.TINY_TRAFFIC.setdefault("train_stage1", tiny.TINY_TRAFFIC["train"])
