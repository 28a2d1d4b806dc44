"""Neural-field decoders (counterpart of ``nsdp_tpu/models/decoders.py``):
cross-attention (``:23-64`` and its fast path
``nsdp_tpu/models/fast_decoder.py:66-132``; reference
``model/decoder/crosstransformer_decoder.py``) and the Gaussian-kernel
interpolation ablation (``:67-112``; reference
``model/decoder/interpolation_decoder.py``).

Both output the deformed *absolute* position of every query point.
"""

import torch
from torch import nn

from nsdp_tpu_torch.nn.blocks import CrossTransformerBlock, Dense, ResnetBlockFC
from nsdp_tpu_torch.ops.knn import square_distance


class CrossTransformerDecoder(nn.Module):
    """One CrossTransformerBlock over the ``nneigh`` nearest anchors + the
    global latent token, then a conditioned ResNet-FC stack and a linear
    head."""

    def __init__(self, dim_inp: int, dim: int, nneigh: int = 7,
                 hidden_dim: int = 64, n_blocks: int = 5, out_dim: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.ct1 = CrossTransformerBlock(dim_inp, dim, nneigh, device, dtype)
        self.init_enc = Dense(dim, hidden_dim, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            ResnetBlockFC(hidden_dim, device=device, dtype=dtype) for _ in range(n_blocks)
        )
        self.fc_c = nn.ModuleList(
            Dense(dim, hidden_dim, device=device, dtype=dtype) for _ in range(n_blocks)
        )
        self.fc_out = Dense(hidden_dim, out_dim, device=device, dtype=dtype)

    def forward(self, xyz_q, encoding):
        lat = self.ct1(xyz_q, encoding["z"], encoding["anchors"],
                       encoding["anchor_feats"])
        net = self.init_enc(lat)
        for blk, fc in zip(self.blocks, self.fc_c):
            net = blk(net + fc(lat))
        return self.fc_out(torch.relu(net))


class PointInterpDecoder(nn.Module):
    """Gaussian-kernel interpolation decoder (ablation).

    Anchor features are kernel-regressed at the query positions
    (``var`` = 0.2^2), then go through the conditioned ResNet-FC stack.
    The weights are normalised without a max shift, as in the JAX package
    and the reference (``nsdp_tpu/models/decoders.py:88-96``): in float32
    every weight underflows to 0 once a query is more than about 2.03 from
    every anchor, and the output is then NaN.
    """

    def __init__(self, dim_inp: int, dim: int, out_dim: int = 3, hidden_dim: int = 50,
                 n_blocks: int = 5, var: float = 0.2 ** 2, device=None, dtype=None):
        super().__init__()
        self.var = var
        self.fc0 = Dense(dim_inp, dim, device=device, dtype=dtype)
        self.fc1 = Dense(dim, hidden_dim, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            ResnetBlockFC(hidden_dim, device=device, dtype=dtype) for _ in range(n_blocks)
        )
        self.fc_c = nn.ModuleList(
            Dense(dim, hidden_dim, device=device, dtype=dtype) for _ in range(n_blocks)
        )
        self.fc_out = Dense(hidden_dim, out_dim, device=device, dtype=dtype)

    def forward(self, xyz_q, encoding):
        # the reference adds 1e-5 to the norm before squaring; reproduced
        dist = torch.sqrt(torch.clamp(square_distance(xyz_q, encoding["anchors"]), min=1e-12))
        weight = torch.exp(-((dist + 1e-5) ** 2) / self.var)
        weight = weight / torch.sum(weight, dim=2, keepdim=True)
        # a narrow anchor_feats is promoted to the weights' float32, as
        # jnp.einsum promotes it
        lat = self.fc0(torch.matmul(weight, encoding["anchor_feats"].to(weight.dtype)))
        net = self.fc1(torch.relu(lat))
        for blk, fc in zip(self.blocks, self.fc_c):
            net = blk(net + fc(lat))
        return self.fc_out(torch.relu(net))


decoder_dict = {
    "crossatten": CrossTransformerDecoder,
    "interp": PointInterpDecoder,
}
