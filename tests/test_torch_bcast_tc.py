"""K1's broadcast path on the tensor cores, host side, on the CPU.

A float32 K1 call whose query is one row broadcast over the batch item's
queries (row stride 0), with a global slot and ``k <= 8``, takes the
broadcast path (``csrc/attention.cu``'s ``attn_bcast_kernel``).  Where no
backward follows (no operand requires grad: serving, sessions,
``predict``, validation) it runs the 3xTF32 tensor-core engine
(``attn_bcast_kernel<0, NW, NWG>``, ``rows_mma.cuh``'s ring engine); in
``_FusedAttention``'s forward it keeps the FFMA engine, whose bits K2's
recompute matches.  Here: the wrapper's choice of kernel (a Python mirror
of the C selection, and ``_launch`` driven against a stand-in library that
records the mode it is called with), the counters, and the kernel's shape
and shared memory at every width.  The arithmetic is emulated in
``tests/test_torch_tf32_split.py``; the kernel itself runs in
``tests/test_torch_kernels.py`` on the card.
"""

import numpy as np
import pytest
import torch

from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops.attention import k1_path, pad8

SHAPES = {(4, 2), (8, 2), (5, 4), (5, 5), (8, 4)}  # the instantiations of attention.cu


@pytest.mark.parametrize("has_glob,q_sn,k,dtype,differentiable,want", [
    (True, 0, 7, None, False, "bcast_tc"),  # the decoder, no backward: serving, predict
    (True, 0, 8, None, False, "bcast_tc"),
    (True, 0, 1, None, False, "bcast_tc"),
    (True, 0, 7, None, True, "bcast"),  # _FusedAttention's forward: the FFMA engine
    (True, 0, 7, torch.bfloat16, False, "narrow"),  # attn_mma16_kernel
    (True, 0, 7, torch.float16, False, "narrow"),
    (True, 200, 7, None, False, "rows"),  # a query per row
    (True, 0, 9, None, False, "rows"),  # more neighbours than the path takes
    (False, 0, 7, None, False, "rows"),  # no global slot
    (True, 200, 7, None, True, "rows"),
])
def test_k1_path(has_glob, q_sn, k, dtype, differentiable, want):
    """The mirror of ``nsdp_fused_attention``'s selection: the broadcast
    path where ``nsdp_attention_bcast`` holds; its engine by whether a
    backward follows; a narrow ``compute_dtype`` before either."""
    assert k1_path(has_glob, q_sn, k, dtype, differentiable) == want
    assert port_attention.bcast_path(has_glob, q_sn, k) == (has_glob and q_sn == 0 and k <= 8)


class _Library:
    """Stands in for the attention library: records each call's mode and
    scratch pointers, launches nothing."""

    def __init__(self):
        self.calls = []

    def nsdp_fused_attention(self, *args):
        self.calls.append(dict(glog=args[20], wt=args[21], frag=args[22], mode=args[28],
                               round_v=args[29]))
        return 0


def _operands(rng, B=2, nq=20, M=30, D=12, k=7, broadcast=True):
    """``_launch``'s positional operands: a decoder call with a global slot."""
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    q = t(B, 1, D).expand(B, nq, D) if broadcast else t(B, nq, D)
    weights = [t(3, D), t(D), t(D, D), t(D), t(D, D), t(D), t(D, D), t(D)]
    return [t(B, nq, 3), t(B, M, 3), q, t(B, M, D), t(B, M, D), *weights, k, t(B, D), t(B, D), None]


@pytest.mark.parametrize("case,kw,mode,scratch,counted", [
    ("broadcast", {}, port_attention.BCAST_TC_MODE, (True, True, False), "bcast_tc"),
    ("broadcast", {"differentiable": True}, 0, (True, True, False), None),
    ("broadcast", {"compute_dtype": torch.bfloat16}, 1, (True, False, True), "narrow"),
    ("rows", {}, 0, (False, False, False), None),
    ("k9", {}, 0, (False, False, False), None),
])
def test_launch_takes_the_engine_of_the_call(case, kw, mode, scratch, counted, monkeypatch):
    """``_launch`` on a stand-in library: the mode it passes, the scratch it
    allocates (global logits, the weights' layout, the narrow fragments)
    and the counters it moves -- ``bcast_tc_launches`` only for the
    tensor-core engine, ``launches`` for every call."""
    lib = _Library()
    monkeypatch.setattr(port_attention._build, "load", lambda name, sig: lib)
    monkeypatch.setattr(port_attention._build, "stream_of", lambda t: 0)
    ops = _operands(np.random.RandomState(0), broadcast=case != "rows", k=9 if case == "k9" else 7)
    f = port_attention.fused_vector_attention
    before = (f.launches, f.bcast_tc_launches, f.narrow_launches)
    out, idx = port_attention._launch(*ops, **kw)
    assert out.shape == (2, 20, 12) and idx.shape == (2, 20, ops[13]) and idx.dtype == torch.int32
    (call,) = lib.calls
    assert call["mode"] == mode and call["round_v"] == int(mode in (1, 2))
    assert (call["glog"] is not None, call["wt"] is not None, call["frag"] is not None) == scratch
    assert (f.launches, f.bcast_tc_launches, f.narrow_launches) == (
        before[0] + 1, before[1] + (counted == "bcast_tc"), before[2] + (counted == "narrow"))


def test_shape_and_shared_memory_at_every_width():
    """At every D the kernel takes: its warpgroups and n-tiles cover
    pad8(D) with an instantiated shape (no padding at the decoder's D =
    200, 5 x 5); its shared memory is under a block's 227 KB with at least
    four ring slots, two blocks an SM where a block is two warpgroups; its
    weights' scratch is three split weights, pad8(D) x Np."""
    for D in range(1, 257):
        nw, nwg = port_attention.bcast_tc_shape(D)
        assert (nw, nwg) in SHAPES, D
        cols = port_attention.bcast_tc_cols(D)
        assert cols == 8 * nw * nwg >= pad8(D) > cols - 64, D
        smem = port_attention.bcast_tc_smem_bytes(D)
        assert smem <= port_attention.MAX_SMEM, (D, smem)
        assert 4 <= port_attention.bcast_tc_slots(D) <= port_attention.BCAST_TC_MAX_SLOTS, D
        blocks = 2 if nwg == 2 else 1  # launch_bcast_tc's residency
        assert blocks * (smem + 1024) <= port_attention.SM_SMEM, (D, smem)
        assert port_attention.bcast_tc_weight_floats(D) == 6 * pad8(D) * cols
    assert port_attention.bcast_tc_shape(200) == (5, 5) and port_attention.bcast_tc_cols(200) == 200


@pytest.mark.parametrize("D,nw_nwg,slots,smem", [
    # phase 2's widths: activations 64 x (pad8(D) + 4) floats, values 64 x
    # (pad8(D) moved to 8 or 24 mod 32), 1.25 KB per-row scratch, six
    # pad8(D)-wide rows of constants; ring slots of 16 Np floats and two
    # 8-byte mbarriers (full, empty)
    (120, (8, 2), 5, 4 * 64 * (124 + 120 + 4) + 256 + 24 * 120 + 5 * (64 * 128 + 16)),
    (200, (5, 5), 8, 4 * 64 * (204 + 200 + 4) + 256 + 24 * 200 + 8 * (64 * 200 + 16)),
    (256, (8, 4), 5, 4 * 64 * (260 + 264 + 4) + 256 + 24 * 256 + 5 * (64 * 256 + 16)),
])
def test_shared_memory_at_phase2_widths(D, nw_nwg, slots, smem):
    assert port_attention.bcast_tc_shape(D) == nw_nwg
    assert port_attention.bcast_tc_slots(D) == slots
    assert port_attention.bcast_tc_smem_bytes(D) == smem < 232448
