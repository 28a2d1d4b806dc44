"""The tiny checkout's sizes for the entry ``serve_mixed``: ``serve``'s,
with query counts that fall into two of the service's buckets."""

from nsdp_bench.tests import tiny

tiny.TINY_TRAFFIC.setdefault(
    "serve_mixed", dict(tiny.TINY_TRAFFIC["serve"], queries={"low": 1000, "high": 20000,
                                                             "dist": "loguniform"}))
