"""Deformation networks (counterpart of ``nsdp_tpu/models/deformation.py`` and
the inference composition of ``nsdp_tpu/models/fast_predict.py:87-209``).

Input contract (as the reference's): ``surface_samples_inputs`` is
(B, N, 7) -- source surface xyz, target xyz * handle mask, mask.  The
"backward" net (``no_input_corr``) conditions on the source xyz only; the
"forward" net on all 7 channels.  ``points`` (B, Q, 3) are query positions;
the output is their deformed absolute position.

``predict`` takes ``compute_dtype`` (``torch.bfloat16`` or
``torch.float16``), the counterpart of ``make_fast_predict(compute_dtype=)``
(``nsdp_tpu/models/fast_predict.py:87-235``): every kNN attention of the
call (K1) runs its narrow-operand mode (``ops/attention.py``), every other
layer computes as the model's own dtype says.  Inference only: with grad
mode on the attention raises.  A caller of ``canonicalize`` or ``deform``
alone enters ``ops.attention.attention_dtype(...)`` around the call.
"""

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nsdp_tpu_torch.nn.blocks import checkpoint_contexts
from nsdp_tpu_torch.ops.attention import attention_dtype


def _narrow(compute_dtype):
    """The attention's narrow-operand mode for a call, or nothing."""
    return contextlib.nullcontext() if compute_dtype is None else attention_dtype(compute_dtype)


class DeformationNetwork(nn.Module):
    """One encoder + one decoder.  ``encode`` and ``decode`` are separate so
    a caller can encode a conditioning cloud once and decode many query
    sets.

    ``remat``: in train mode with grad on, each encoder and decoder call
    runs under ``torch.utils.checkpoint`` (non-reentrant), keeping only its
    inputs and recomputing its activations in the backward, as ``nn.remat``
    does (``nsdp_tpu/models/__init__.py:77-84``).  The recompute normalises
    with the same batch statistics but updates no BatchNorm running
    statistic (``nn.blocks.checkpoint_contexts``), and under ``bn_sync`` it
    all-reduces them again, on every rank alike.  Eval mode and
    ``torch.no_grad`` call the modules directly."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 no_input_corr: bool = False, use_normals: bool = False,
                 remat: bool = False):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.no_input_corr = no_input_corr
        self.use_normals = use_normals
        self.remat = remat

    def _call(self, module, *args):
        if self.remat and self.training and torch.is_grad_enabled():
            # the model draws no random numbers, so no RNG state is stashed
            # for the recompute (reading the card's RNG state is not allowed
            # inside a CUDA graph capture)
            return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=checkpoint_contexts)
        return module(*args)

    def encode(self, surface_samples_inputs, point_mask=None):
        if self.no_input_corr:
            end = 6 if self.use_normals else 3
            surface_samples_inputs = surface_samples_inputs[:, :, 0:end]
        return self._call(self.encoder, surface_samples_inputs, point_mask)

    def decode(self, points, encoding):
        return self._call(self.decoder, points, encoding)

    def forward(self, points, surface_samples_inputs, point_mask=None):
        return self.decode(points, self.encode(surface_samples_inputs, point_mask))

    def predict(self, points, surface_samples_inputs, point_mask=None, compute_dtype=None):
        """The serving convention, the same call as :meth:`forward`;
        ``compute_dtype``: K1's narrow mode (module docstring)."""
        with _narrow(compute_dtype):
            return self(points, surface_samples_inputs, point_mask)


class FlowArbitrary(nn.Module):
    """Arbitrary-pose deformation: source -> canonical -> target
    (reference ``model/flow_arbitrary.py:7-27``).

    Split at the canonical pose: :meth:`canonicalize` depends only on the
    source surface (an editing session runs it once), :meth:`deform` runs per
    target; ``predict == deform o canonicalize``.  The source surface is
    encoded once and decoded at both query sets.
    """

    def __init__(self, model_canonicalize: DeformationNetwork,
                 model_deform: DeformationNetwork):
        super().__init__()
        self.model_canonicalize = model_canonicalize
        self.model_deform = model_deform

    def canonicalize(self, points, surf_src, point_mask=None):
        """-> (space_cano (B, Q, 3), surf_cano (B, N, 3))."""
        net = self.model_canonicalize
        enc = net.encode(surf_src, point_mask)
        space_cano = net.decode(points, enc)
        surf_cano = net.decode(surf_src, enc)
        if point_mask is not None:
            # padded rows decode to garbage; re-zero them so the forward
            # conditioning keeps its padding at the origin
            surf_cano = surf_cano * point_mask[..., None].to(surf_cano.dtype)
        return space_cano, surf_cano

    def deform(self, space_cano, surf_cano, surf_tgt, mask, point_mask=None):
        # a narrow canonical pose is promoted beside the float32 target, as
        # jnp.concatenate promotes it
        conditioning = torch.cat([surf_cano, surf_tgt, mask], dim=-1)
        return self.model_deform(space_cano, conditioning, point_mask)

    def forward(self, space_samples_src, surface_samples_src,
                surface_samples_tgt, cano_handle_sample_mask, point_mask=None):
        space_cano, surf_cano = self.canonicalize(
            space_samples_src, surface_samples_src, point_mask
        )
        return self.deform(space_cano, surf_cano, surface_samples_tgt,
                           cano_handle_sample_mask, point_mask)

    def predict(self, points, surface_samples_inputs, point_mask=None, compute_dtype=None):
        """The serving convention: ``surface_samples_inputs`` packs
        [source xyz | masked target xyz | handle mask] (B, N, 7);
        ``compute_dtype``: K1's narrow mode (module docstring)."""
        with _narrow(compute_dtype):
            return self(points, surface_samples_inputs[:, :, 0:3],
                        surface_samples_inputs[:, :, 3:6],
                        surface_samples_inputs[:, :, 6:7], point_mask)
