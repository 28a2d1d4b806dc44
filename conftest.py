"""The tiny checkout's sizes (``nsdp_bench/tests/tiny.py``) for the
benchmark entry ``train_bf16``: ``train``'s, the bfloat16 steps on the
same tiny batches."""

from nsdp_bench.tests import tiny

tiny.TINY_TRAFFIC.setdefault("train_bf16", tiny.TINY_TRAFFIC["train"])
