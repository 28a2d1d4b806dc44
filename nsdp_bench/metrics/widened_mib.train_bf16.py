"""MiB of narrow operands a train step widens to float32: the growth of the
program's counters ``fused_vector_attention.widened_bytes`` (before K1/K2)
and ``BatchNorm.widened_bytes`` (into each BatchNorm) over one eager step
(``entries/train_bf16.py``).  A program without the counters gives
nothing."""


def read(o):
    return o.counters.get("widened_mib")
