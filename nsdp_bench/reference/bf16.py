"""NSDP's arbitrary-pose model trained with ``compute_dtype: bfloat16``, in
plain PyTorch: ``model.py``'s float32 reference with its linear, BatchNorm
and attention hooks rounding where the setting says to.

The setting is the repository's own (``nsdp_tpu/models/__init__.py:110-122``;
``nsdp_tpu/nn/blocks.py``, restated in ``nsdp_tpu_torch/nn/blocks.py:19-23``):
every layer that the model builds with ``dtype=`` computes in bfloat16,
every other layer in float32; parameters, BatchNorm statistics and Adam's
state stay float32.  Layer by layer, in the published names:

* a linear layer built with the dtype (flax's ``Dense(dtype=)``): input,
  weight and bias rounded to bfloat16, the product rounded to bfloat16
  before the bias add, the sum rounded again: a bfloat16 output.  These
  are, in each encoder, ``enc_sdf``; each set abstraction's ``w_qs``,
  ``w_qs2``, ``conv1`` and ``conv2``, and its ``w_ks``/``w_vs``/``w_ks2``/
  ``w_vs2`` where the JAX package does not project the keys and values
  inside its attention kernel (:func:`kv_in_kernel`; where it does, the
  projection is float32 from the widened features); every element-wise
  block's ``conv1``/``conv2``; ``fc1``; ``fc_middle``; and, where the final
  transformers attend to every anchor (``full_SA``), their ``fc_delta``,
  ``fc_gamma``, ``w_qs``, ``w_ks`` and ``w_vs``.  In each decoder: ``ct1``'s
  ``w_k_global``, ``w_v_global``, ``w_qs``, ``w_ks`` and ``w_vs``;
  ``init_enc``; every ``fc_c``; every ResNet block's ``fc_0``/``fc_1``;
  ``fc_out``;
* a linear layer built without it computes in float32 from its widened
  input: the kNN transformers' ``w_qs``/``w_ks``/``w_vs``
  (``transformer_begin``, ``transformer_downs``; ``nsdp_tpu/nn/blocks.py``'s
  fused branch builds them without ``dtype``);
* BatchNorm (every one is built with the dtype): statistics, running
  statistics and normalisation in float32 from the widened input, the
  output rounded to bfloat16;
* kNN vector attention (every attention but the group-all one): float32,
  its bfloat16 operands widened (coordinates, q, K, V, the global slot's
  key and value); its MLPs (``fc_delta*``, ``fc_gamma*``) are float32 on
  float32 weights, and its output is float32;
* group-all attention: every step in bfloat16, the softmax as
  ``jax.nn.softmax``'s steps, each rounded: ``e = exp(l - max l)``,
  ``e / sum e``;
* between layers torch's type promotion, which is ``jnp``'s here: two
  bfloat16 operands give a rounded bfloat16 result (the element-wise
  blocks' residual, the decoder's ``net + fc_c(lat)``), a bfloat16 and a
  float32 operand a float32 one (a kNN attention's residual, the set
  abstraction's ``res1 + conv2(h)``);
* so the canonicalising decoder's outputs, the canonical space points and
  surface, are bfloat16, and the forward net's FPS, kNN and position
  encodings select and compute on those rounded coordinates; the
  deformed points are bfloat16, and the loss is float32 against the
  float32 targets.

Departures, besides ``model.py``'s own (kNN and FPS ties, every
neighbourhood materialised): the canonicalising net encodes the surface
once for its two decodings, as the program and the JAX package compose
the step (``nsdp_tpu/training/steps.py:28-42``), where the published
model encodes it twice: in float32 the two agree to rounding, in
bfloat16 the encoder's output gradients from the two decodings are
summed, and rounded, before its backward; its BatchNorms still take the
published two running-statistics updates.  A bfloat16 reduction (a row
sum of the group-all softmax, a matrix product) accumulates as torch
accumulates it on the device at hand, in float32 with one rounding at
the end, where the JAX package accumulates as XLA does.  The float32
attention and BatchNorm sum in another order than the kernels do, and a
float32 difference of one rounding may turn a bfloat16 rounding of a
later layer the other way; the comparison is built on that noise
(``entries/train_bf16.py``, ``PERF.md``).

It imports nothing of the program under test and turns TF32 off where it
runs.  :func:`train_step_counts` records a step's matrix-product
operations by the type they run in.
"""

from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nsdp_bench.reference import model

NARROW = torch.bfloat16
# the MLPs of every kNN attention, float32 whatever the dtype
ATTENTION_MLPS = ("fc_delta", "fc_gamma", "fc_delta1", "fc_gamma1", "fc_gamma2")
KV_PROJECTIONS = ("w_ks", "w_vs", "w_ks2", "w_vs2")


def kv_in_kernel(m: int, f: int, d: int) -> bool:
    """Whether the JAX package projects a set abstraction's keys and values
    inside its attention kernel (in float32, ``attention_pallas.py:1251-1262``)
    for ``m`` kv points of ``f`` features projected to ``d``."""
    round_up = lambda x: -(-x // 128) * 128
    saved = round_up(8 + d) + round_up(d) - round_up(8 + f)
    return round_up(m) * saved >= 4 * f * d


class Reference(model.Reference):
    """:class:`model.Reference` with ``compute_dtype: bfloat16`` (the module
    docstring's rule)."""

    def __init__(self, model_cfg: Dict, params: Dict[str, torch.Tensor]):
        if model_cfg["encoder"] != "pointransformer" or model_cfg["decoder"] != "crossatten":
            raise ValueError("the rounding reference covers the pointransformer encoder and the "
                             "crossatten decoder")
        super().__init__(model_cfg, params)
        self.updates = 1  # running-statistics updates a train-mode BatchNorm makes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def narrow_layer(self, name: str, x: torch.Tensor, w: torch.Tensor) -> bool:
        """Whether the linear layer ``name`` (on input ``x``, weight ``w``)
        is built with the dtype."""
        parts = name.split(".")
        layer = parts[-2] if parts[-1].isdigit() else parts[-1]
        if "decoder" in parts:
            return layer not in ATTENTION_MLPS
        if "transformer_begin" in parts or "transformer_downs" in parts:
            return False
        if "final_transformers" in parts:
            return bool(self.cfg["encoder_kwargs"].get("full_SA", False))
        if "transition_downs" in parts:
            if layer in ATTENTION_MLPS:
                return False
            if layer in KV_PROJECTIONS:
                return not kv_in_kernel(x.shape[-2], x.shape[-1], w.shape[0])
        return True

    def linear(self, name, x):
        w = self.p[f"{name}.weight"]
        if self.narrow_layer(name, x, w):
            b = self.p.get(f"{name}.bias")
            y = x.to(NARROW) @ w.to(NARROW).t()
            return y if b is None else y + b.to(NARROW)
        return super().linear(name, x.float())

    def bn(self, name, x):
        x = x.float()
        if self.training and not self.calibrate and self.updates == 2:
            super().bn(name, x)  # the published second encoding's update
        return super().bn(name, x).to(NARROW)

    def canonicalize(self, points, surf_src, twice: Optional[bool] = None):
        """The surface encoded once for both decodings, as the program
        and the JAX package compose the step; in train mode each BatchNorm
        of the encoder still takes the two running-statistics updates of
        the published model's two encodings (``twice``, the default)."""
        net = "model_canonicalize"
        self.updates = 2 if twice is None or twice else 1
        try:
            enc = self.encode(net, surf_src, False)
        finally:
            self.updates = 1
        return self.decode(net, points, enc), self.decode(net, surf_src, enc)

    def attention(self, xyz_q, kv_xyz, q, K, V, delta, gamma, k, k_glob=None, v_glob=None):
        widen = lambda t: None if t is None else t.float()
        return super().attention(widen(xyz_q), widen(kv_xyz), widen(q), widen(K), widen(V),
                                 delta, gamma, k, widen(k_glob), widen(v_glob))

    def transformer(self, name, xyz, feats, k, group_all=False):
        if not group_all:
            return super().transformer(name, xyz, feats, k, group_all)
        pos = self.mlp2(f"{name}.fc_delta", xyz[:, :, None, :] - xyz[:, None, :, :])
        q, kk, v = (self.linear(f"{name}.{w}", feats) for w in ("w_qs", "w_ks", "w_vs"))
        logits = self.mlp2(f"{name}.fc_gamma", q[:, :, None, :] - kk[:, None, :, :] + pos)
        e = torch.exp(logits - logits.amax(dim=-2, keepdim=True))
        attn = e / e.sum(dim=-2, keepdim=True)
        return self.bn(f"{name}.bn", torch.sum(attn * (v[:, None, :, :] + pos), dim=-2) + feats)


class MatmulFlops(TorchDispatchMode):
    """Counts the operations (2 per multiply-add) of every matrix product
    run inside it, by the type of its operands."""

    PRODUCTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}

    def __init__(self):
        super().__init__()
        self.flops: Dict[torch.dtype, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        at = self.PRODUCTS.get(func._overloadpacket.__name__)
        if at is not None:
            a, b = args[at[0]], args[at[1]]
            self.flops[a.dtype] += 2.0 * a.numel() * b.shape[-1]
        return out


def train_step_counts(model_cfg: Dict, B: int, n_surface: int, n_queries: int) -> Dict:
    """One stage-2 train step (forward, loss, backward; the surface encoded
    once, as the program encodes it) on the ``meta`` device: ``sites`` (its
    forward attention calls, each with a backward), ``flops_narrow`` and
    ``flops_f32`` (the matrix products in bfloat16 and in float32) and
    ``flops``, their sum."""
    params = {name: torch.empty(shape, dtype=torch.long if kind == "count" else torch.float32,
                                device="meta")
              for name, shape, kind in model.parameter_spec(model_cfg)}
    ref = Reference(model_cfg, params).train()
    ref.record = True
    leaves = [params[n].requires_grad_() for n, _, kind in model.parameter_spec(model_cfg)
              if kind in ("weight", "bias", "bn_weight", "bn_bias")]
    pts = torch.empty((B, n_queries, 3), device="meta")
    inp = torch.empty((B, n_surface, 7), device="meta")
    with MatmulFlops() as counter:
        loss = model.l2_loss(ref.predict(pts, inp, twice=False), pts)
        torch.autograd.grad(loss, leaves)
    narrow = counter.flops[NARROW]
    f32 = sum(v for dtype, v in counter.flops.items() if dtype != NARROW)
    return {"sites": list(ref.sites), "flops_narrow": narrow, "flops_f32": f32,
            "flops": narrow + f32}
