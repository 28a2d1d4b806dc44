"""Point-cloud encoders (counterpart of ``nsdp_tpu/models/encoders.py``):
the hierarchical Point Transformer (``:22-141`` and its eval fast path
``nsdp_tpu/models/fast_encoder.py:168-243``; reference
``model/encoder/pointransformer.py``) and the PointNet++ ablation
(``:168-223``; reference ``model/encoder/pointnetplusplus.py``).  Both
return ``{'z': (B, D), 'anchors': (B, A, 3), 'anchor_feats': (B, A, D)}``."""

from typing import Sequence

from torch import nn

from nsdp_tpu_torch.nn.blocks import (
    ElementwiseMLP,
    TransformerBlock,
    TransitionDown,
    TwoLayerMLP,
)


class PointTransformerEncoder(nn.Module):
    """Returns ``{'z': (B, d_transformer), 'anchors': (B, A, 3),
    'anchor_feats': (B, A, d_transformer)}``.

    1. optional feature lift of the non-xyz channels (``enc_sdf``);
    2. a local TransformerBlock at full resolution in ``d_reduced``;
    3. per level: attentive set abstraction (FPS + two cross-attention
       rounds) -> ElementwiseMLP -> local TransformerBlock, with a
       ``d_reduced -> d_transformer`` projection after level 0;
    4. ``nfinal_transformers`` full (``full_SA``) or local self-attention
       blocks over the anchors;
    5. max-pool over anchors -> 2-layer MLP for the global latent.

    ``point_mask`` (B, N), nonzero = real point: padded rows sit at the
    origin (never an FPS pick) and are removed from the kNN neighbourhoods
    of the full-resolution stages.
    """

    def __init__(self, npoints_per_layer: Sequence[int], nneighbor: int,
                 nneighbor_reduced: int, nfinal_transformers: int,
                 d_transformer: int, d_reduced: int, full_SA: bool = False,
                 has_features: bool = False, inp_feat_dim: int = 1,
                 device=None):
        super().__init__()
        self.has_features = has_features
        self.project = d_reduced != d_transformer
        if has_features:
            self.enc_sdf = nn.Linear(inp_feat_dim, d_reduced, device=device)
        self.transformer_begin = TransformerBlock(
            d_reduced, nneighbor_reduced, pos_only=not has_features, device=device
        )
        self.transition_downs = nn.ModuleList()
        self.elementwise_extras = nn.ModuleList()
        self.transformer_downs = nn.ModuleList()
        self.elementwise = nn.ModuleList()
        for i in range(len(npoints_per_layer) - 1):
            old_n, new_n = npoints_per_layer[i], npoints_per_layer[i + 1]
            dim = d_reduced if i == 0 else d_transformer
            self.transition_downs.append(
                TransitionDown(new_n, min(nneighbor, old_n), dim, device=device)
            )
            self.elementwise_extras.append(ElementwiseMLP(dim, device))
            self.transformer_downs.append(
                TransformerBlock(dim, min(nneighbor, new_n), device=device)
            )
            self.elementwise.append(ElementwiseMLP(d_transformer, device))
        if self.project:
            self.fc1 = nn.Linear(d_reduced, d_transformer, device=device)
        self.final_transformers = nn.ModuleList(
            TransformerBlock(d_transformer, 2 * nneighbor, group_all=full_SA,
                             device=device)
            for _ in range(nfinal_transformers)
        )
        self.final_elementwise = nn.ModuleList(
            ElementwiseMLP(d_transformer, device) for _ in range(nfinal_transformers)
        )
        self.fc_middle = TwoLayerMLP(d_transformer, d_transformer, device)

    def forward(self, xyz, point_mask=None):
        if self.has_features:
            feats = self.enc_sdf(xyz[:, :, 3:])
            xyz = xyz[:, :, :3]
            feats = self.transformer_begin(xyz, feats, point_mask)
        else:
            feats = self.transformer_begin(xyz, None, point_mask)
        for i, td in enumerate(self.transition_downs):
            # after the first downsampling every surviving point is real
            xyz, feats = td(xyz, feats, point_mask if i == 0 else None)
            feats = self.elementwise_extras[i](feats)
            feats = self.transformer_downs[i](xyz, feats)
            if i == 0 and self.project:
                feats = self.fc1(feats)
            feats = self.elementwise[i](feats)
        for tb, ew in zip(self.final_transformers, self.final_elementwise):
            feats = ew(tb(xyz, feats))
        z = self.fc_middle(feats.amax(dim=1))
        return {"z": z, "anchors": xyz, "anchor_feats": feats}


class PointNetPlusPlusEncoder(nn.Module):
    """PointNet++-style ablation encoder (``nsdp_tpu/models/encoders.py:168-223``):

    1. ``fc_begin`` lifts the non-xyz channels (``has_features``) or xyz;
    2. per level: max-pool set abstraction (FPS + kNN grouping + max,
       :class:`PointNetSetAbstraction`) -> ElementwiseMLP;
    3. ``nfinal_transformers`` full self-attention blocks over the anchors,
       each followed by an ElementwiseMLP;
    4. max-pool over anchors -> 2-layer MLP for the global latent.

    ``point_mask`` (B, N), nonzero = real point, reaches the first level
    only: after it every surviving point is real.
    """

    def __init__(self, npoints_per_layer: Sequence[int], nneighbor: int,
                 d_transformer: int, nfinal_transformers: int,
                 has_features: bool = False, inp_feat_dim: int = 1, device=None):
        super().__init__()
        self.has_features = has_features
        d = d_transformer
        self.fc_begin = TwoLayerMLP(inp_feat_dim if has_features else 3, d, device)
        self.transition_downs = nn.ModuleList()
        self.elementwise = nn.ModuleList()
        for i in range(len(npoints_per_layer) - 1):
            old_n, new_n = npoints_per_layer[i], npoints_per_layer[i + 1]
            self.transition_downs.append(
                TransitionDown(new_n, min(nneighbor, old_n), d, sa_type="maxpool", device=device)
            )
            self.elementwise.append(ElementwiseMLP(d, device))
        self.final_transformers = nn.ModuleList(
            TransformerBlock(d, -1, group_all=True, device=device)
            for _ in range(nfinal_transformers)
        )
        self.final_elementwise = nn.ModuleList(
            ElementwiseMLP(d, device) for _ in range(nfinal_transformers)
        )
        self.fc_middle = TwoLayerMLP(d, d, device)

    def forward(self, xyz, point_mask=None):
        if self.has_features:
            feats = self.fc_begin(xyz[:, :, 3:])
            xyz = xyz[:, :, :3]
        else:
            feats = self.fc_begin(xyz)
        for i, (td, ew) in enumerate(zip(self.transition_downs, self.elementwise)):
            xyz, feats = td(xyz, feats, point_mask if i == 0 else None)
            feats = ew(feats)
        for tb, ew in zip(self.final_transformers, self.final_elementwise):
            feats = ew(tb(xyz, feats))
        z = self.fc_middle(feats.amax(dim=1))
        return {"z": z, "anchors": xyz, "anchor_feats": feats}


encoder_dict = {
    "pointransformer": PointTransformerEncoder,
    "pointnet++": PointNetPlusPlusEncoder,
}
