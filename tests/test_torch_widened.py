"""The port's precision-boundary counters, on the CPU:
``fused_vector_attention.widened_bytes`` (the bytes of narrow operands a
kNN attention widens to float32) and ``BatchNorm.widened_bytes`` (the
bytes of narrow input a BatchNorm takes to float32).  Both grow at the
call, by the operands' elements at their own width, under
``compute_dtype: bfloat16``, and stay at 0 in float32."""

import numpy as np
import pytest
import torch

from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.nn.blocks import BatchNorm
from nsdp_tpu_torch.ops.attention import fused_vector_attention
from nsdp_tpu_torch.training import make_steps, optimizer_factory
from tests.test_torch_tracing import CONFIG, batch

BF16 = torch.bfloat16


def widened():
    return fused_vector_attention.widened_bytes, BatchNorm.widened_bytes


def mlp(d_in, d, gen):
    return (torch.randn(d_in, d, generator=gen), torch.randn(d, generator=gen),
            torch.randn(d, d, generator=gen), torch.randn(d, generator=gen))


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_attention_counts_the_operands_it_widens(dtype):
    """A decoder-style call (a query broadcast over the queries, a global
    slot) counts q's every element, K, V and the global key and value; the
    float32 coordinates and weights count nothing; a float32 call counts
    nothing."""
    B, Nq, M, D, k = 2, 9, 6, 8, 3
    gen = torch.Generator().manual_seed(0)
    xyz_q, kv_xyz = torch.randn(B, Nq, 3, generator=gen), torch.randn(B, M, 3, generator=gen)
    q = torch.randn(B, D, generator=gen).to(dtype)[:, None, :].expand(B, Nq, D)
    K, V = (torch.randn(B, M, D, generator=gen).to(dtype) for _ in range(2))
    k_glob, v_glob = (torch.randn(B, D, generator=gen).to(dtype) for _ in range(2))
    before = widened()
    out = fused_vector_attention(xyz_q, kv_xyz, q, K, V, *mlp(3, D, gen), *mlp(D, D, gen), k=k,
                                 k_glob=k_glob, v_glob=v_glob)
    after = widened()
    assert out.dtype == torch.float32
    want = 2 * (B * Nq * D + 2 * B * M * D + 2 * B * D) if dtype == BF16 else 0
    assert (after[0] - before[0], after[1] - before[1]) == (want, 0)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_counts_its_narrow_input(train):
    """A BatchNorm of the compute dtype counts its bfloat16 input's bytes
    in train and eval mode, and a float32 input's none."""
    bn = BatchNorm(5, dtype=BF16).train(train)
    x = torch.randn(3, 7, 5)
    before = widened()
    assert bn(x.to(BF16)).dtype == BF16
    middle = widened()
    assert bn(x).dtype == BF16
    after = widened()
    assert (middle[0] - before[0], middle[1] - before[1]) == (0, 3 * 7 * 5 * 2)
    assert after == middle


@pytest.mark.parametrize("compute_dtype", ["bfloat16", None])
def test_a_train_step_widens_only_in_bfloat16(compute_dtype):
    """A stage-2 step of a small model: under ``compute_dtype: bfloat16``
    both counters grow, by the same bytes at each step of one shape (the
    CPU runs every step's Python); in float32 neither moves."""
    model_cfg = dict(CONFIG["model"])
    if compute_dtype:
        model_cfg["compute_dtype"] = compute_dtype
    model = init_random(build_model({**CONFIG, "model": model_cfg}, device="cpu"), 0)
    _, opt = optimizer_factory(CONFIG["training"], model.parameters())
    step = make_steps(model, "arbitrary", opt, device="cpu", graphs=True)["train_step"]
    rng = np.random.RandomState(3)
    grown = []
    for _ in range(2):
        before = widened()
        step(batch(rng), 1e-3)
        after = widened()
        grown.append((after[0] - before[0], after[1] - before[1]))
    if compute_dtype:
        assert grown[0] == grown[1] and min(grown[0]) > 0
    else:
        assert grown == [(0, 0), (0, 0)]
