"""Cross-attention neural-field decoder (counterpart of
``nsdp_tpu/models/decoders.py:23-64`` and its fast path
``nsdp_tpu/models/fast_decoder.py:66-132``; reference
``model/decoder/crosstransformer_decoder.py``).

Outputs the deformed *absolute* position of every query point.
"""

import torch
from torch import nn

from nsdp_tpu_torch.nn.blocks import CrossTransformerBlock, ResnetBlockFC


class CrossTransformerDecoder(nn.Module):
    """One CrossTransformerBlock over the ``nneigh`` nearest anchors + the
    global latent token, then a conditioned ResNet-FC stack and a linear
    head."""

    def __init__(self, dim_inp: int, dim: int, nneigh: int = 7,
                 hidden_dim: int = 64, n_blocks: int = 5, out_dim: int = 1,
                 device=None):
        super().__init__()
        self.ct1 = CrossTransformerBlock(dim_inp, dim, nneigh, device)
        self.init_enc = nn.Linear(dim, hidden_dim, device=device)
        self.blocks = nn.ModuleList(
            ResnetBlockFC(hidden_dim, device=device) for _ in range(n_blocks)
        )
        self.fc_c = nn.ModuleList(
            nn.Linear(dim, hidden_dim, device=device) for _ in range(n_blocks)
        )
        self.fc_out = nn.Linear(hidden_dim, out_dim, device=device)

    def forward(self, xyz_q, encoding):
        lat = self.ct1(xyz_q, encoding["z"], encoding["anchors"],
                       encoding["anchor_feats"])
        net = self.init_enc(lat)
        for blk, fc in zip(self.blocks, self.fc_c):
            net = blk(net + fc(lat))
        return self.fc_out(torch.relu(net))
