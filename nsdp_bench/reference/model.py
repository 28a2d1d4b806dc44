"""NSDP's two benchmark configurations in plain float32 PyTorch.

The math of the published model (github.com/tangjiapeng/NSDP:
``model/flow_arbitrary.py``, ``model/deformation_networks.py``,
``model/encoder/{pointransformer,pointnetplusplus,blocks}.py``,
``model/decoder/{crosstransformer_decoder,blocks}.py``), written out as
tensor operations on a flat dict of weights named as the published
checkpoints name them.  It imports nothing of the program under test: no
kernel, no cache, no batching of requests, no captured graph.  Every
neighbourhood is materialised.

Semantics the program must share with it:

* k nearest points by ``((dx*dx + dy*dy) + dz*dz)`` in float32, ascending,
  ties to the lowest index;
* furthest-point sampling from index 0, squared norms and distances summed
  as ``(x*x + y*y) + z*z``; points with ``|p|^2 <= 1e-3`` are never picked
  and never update the running distance (1e10 at the start); ties to the
  lowest index;
* kNN vector attention: per neighbour ``pos = fc_delta(x_q - x_n)``, logits
  ``fc_gamma(q - k_n + pos)`` (``fc_gamma(pos)`` without features), values
  ``v_n + pos`` (``pos``), a per-channel softmax over the neighbours and a
  global slot (``fc_gamma(q - k_glob)``, value ``v_glob``) in the decoder;
  no scaling of the logits;
* BatchNorm over every axis but the last: eval mode with the running
  statistics; train mode normalises with the biased batch variance and
  moves the running statistics by momentum 0.1, the variance Bessel
  corrected;
* the arbitrary-pose composition runs the canonicalising net twice, on the
  space points and on the surface, as the published ``FlowArbitrary``
  does (in train mode its BatchNorm statistics move twice).

``Reference.calibrate`` (train mode) sets each BatchNorm's running
statistics to the batch's, as ``nsdp_bench.weights`` makes its weights.
``Reference.sites`` records every attention call as
``(B, Nq, M, k, D, mode)`` while ``record`` is set: the operation counts of
``nsdp_bench.counts`` read them.
"""

from typing import Dict, List, Optional, Tuple

import torch

EPS = 1e-5  # BatchNorm
MOMENTUM = 0.1
FPS_VALID = 1e-3  # squared norm at or below which FPS never picks a point
CHUNK = 16384  # query rows of one block of the materialised attention


# ------------------------------------------------------------ the parameters


def _linear(spec, name, d_in, d_out, bias=True):
    spec.append((f"{name}.weight", (d_out, d_in), "weight"))
    if bias:
        spec.append((f"{name}.bias", (d_out,), "bias"))


def _mlp2(spec, name, d_in, d):
    _linear(spec, f"{name}.0", d_in, d)
    _linear(spec, f"{name}.2", d, d)


def _bn(spec, name, d):
    spec += [(f"{name}.weight", (d,), "bn_weight"), (f"{name}.bias", (d,), "bn_bias"),
             (f"{name}.running_mean", (d,), "running_mean"),
             (f"{name}.running_var", (d,), "running_var"),
             (f"{name}.num_batches_tracked", (), "count")]


def _elementwise(spec, name, d):
    _linear(spec, f"{name}.conv1", d, d)
    _bn(spec, f"{name}.bn1", d)
    _linear(spec, f"{name}.conv2", d, d)
    _bn(spec, f"{name}.bn2", d)
    _bn(spec, f"{name}.bn3", d)


def _transformer(spec, name, d, pos_only=False):
    _mlp2(spec, f"{name}.fc_delta", 3, d)
    _mlp2(spec, f"{name}.fc_gamma", d, d)
    if not pos_only:
        for w in ("w_qs", "w_ks", "w_vs"):
            _linear(spec, f"{name}.{w}", d, d, bias=False)
    _bn(spec, f"{name}.bn", d)


def _encoder_spec(spec, name, enc, kind, has_features, feat_dim):
    levels = len(enc["npoints_per_layer"]) - 1
    d = enc["d_transformer"]
    if kind == "pointransformer":
        dr = enc["d_reduced"]
        if has_features:
            _linear(spec, f"{name}.enc_sdf", feat_dim, dr)
        _transformer(spec, f"{name}.transformer_begin", dr, pos_only=not has_features)
        for i in range(levels):
            di = dr if i == 0 else d
            sa = f"{name}.transition_downs.{i}.sa"
            _mlp2(spec, f"{sa}.fc_delta1", 3, di)
            _mlp2(spec, f"{sa}.fc_gamma1", di, di)
            _mlp2(spec, f"{sa}.fc_gamma2", di, di)
            for w in ("w_qs", "w_ks", "w_vs", "w_qs2", "w_ks2", "w_vs2"):
                _linear(spec, f"{sa}.{w}", di, di, bias=False)
            _linear(spec, f"{sa}.conv1", di, di)
            _linear(spec, f"{sa}.conv2", di, di)
            for b in ("bn1", "bnorm0", "bnorm1", "bnorm2"):
                _bn(spec, f"{sa}.{b}", di)
        for i in range(levels):
            _elementwise(spec, f"{name}.elementwise_extras.{i}", dr if i == 0 else d)
        for i in range(levels):
            _transformer(spec, f"{name}.transformer_downs.{i}", dr if i == 0 else d)
        for i in range(levels):
            _elementwise(spec, f"{name}.elementwise.{i}", d)
        if dr != d:
            _linear(spec, f"{name}.fc1", dr, d)
    elif kind == "pointnet++":
        _mlp2(spec, f"{name}.fc_begin", feat_dim if has_features else 3, d)
        for i in range(levels):
            sa = f"{name}.transition_downs.{i}.sa"
            _linear(spec, f"{sa}.fc1", d, d)
            _linear(spec, f"{sa}.conv1", d, d)
            _bn(spec, f"{sa}.bn1", d)
            _linear(spec, f"{sa}.conv2", d, d)
            _bn(spec, f"{sa}.bn2", d)
            _bn(spec, f"{sa}.bn", d)
        for i in range(levels):
            _elementwise(spec, f"{name}.elementwise.{i}", d)
    else:
        raise ValueError(f"no reference for the encoder {kind!r}")
    for j in range(enc["nfinal_transformers"]):
        _transformer(spec, f"{name}.final_transformers.{j}", d)
    for j in range(enc["nfinal_transformers"]):
        _elementwise(spec, f"{name}.final_elementwise.{j}", d)
    _mlp2(spec, f"{name}.fc_middle", d, d)


def _decoder_spec(spec, name, dec, kind):
    if kind != "crossatten":
        raise ValueError(f"no reference for the decoder {kind!r}")
    d_in, d, h = dec["dim_inp"], dec["dim"], dec["hidden_dim"]
    _mlp2(spec, f"{name}.ct1.fc_delta", 3, d)
    _mlp2(spec, f"{name}.ct1.fc_gamma", d, d)
    for w in ("w_k_global", "w_v_global", "w_qs", "w_ks", "w_vs"):
        _linear(spec, f"{name}.ct1.{w}", d_in, d, bias=False)
    _linear(spec, f"{name}.init_enc", d, h)
    n_blocks = dec.get("n_blocks", 5)
    for i in range(n_blocks):
        _linear(spec, f"{name}.blocks.{i}.fc_0", h, h)
        _linear(spec, f"{name}.blocks.{i}.fc_1", h, h)
    for i in range(n_blocks):
        _linear(spec, f"{name}.fc_c.{i}", d, h)
    _linear(spec, f"{name}.fc_out", h, dec.get("out_dim", 1))


def parameter_spec(model_cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight and buffer of the configuration as ``(name, shape,
    kind)``, in the published checkpoint's names and order; ``kind`` is
    ``weight`` (a linear layer's, (out, in)), ``bias``, ``bn_weight``,
    ``bn_bias``, ``running_mean``, ``running_var`` or ``count``."""
    if model_cfg["type"] != "arbitrary" or model_cfg.get("use_normals", False):
        raise ValueError("the reference covers the arbitrary-pose composition without normals")
    spec: List = []
    for net, has_features, feat_dim in (("model_canonicalize", False, 0),
                                        ("model_deform", True, 4)):
        _encoder_spec(spec, f"{net}.encoder", model_cfg["encoder_kwargs"], model_cfg["encoder"],
                      has_features, feat_dim)
        _decoder_spec(spec, f"{net}.decoder", model_cfg["decoder_kwargs"], model_cfg["decoder"])
    return spec


# --------------------------------------------------------------- the ops


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows at (B, S) or (B, S, K) indices -> (B, S[, K], C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).long()
    return torch.gather(points, 1, flat[..., None].expand(-1, -1, C)).reshape(*idx.shape, C)


def knn(query: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """(B, Nq, k) indices of the k nearest points, ascending, ties to the
    lowest index, in blocks of query rows."""
    out = []
    for s in range(0, query.shape[1], CHUNK):
        q = query[:, s:s + CHUNK]
        d2 = None
        for c in range(3):
            diff = q[:, :, None, c] - points[:, None, :, c]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        out.append(torch.sort(d2, dim=-1, stable=True)[1][..., :k])
    return torch.cat(out, dim=1)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) indices (on the ``meta`` device, of
    which only the shape is read, no step is run)."""
    B, N, _ = xyz.shape
    if xyz.device.type == "meta":
        return torch.empty((B, npoint), dtype=torch.long, device="meta")
    x, y, z = xyz.unbind(-1)
    valid = (x * x + y * y) + z * z > FPS_VALID
    dist = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        dist = torch.where(valid, torch.minimum(dist, (dx * dx + dy * dy) + dz * dz), dist)
        last = torch.argmax(torch.where(valid, dist, torch.full_like(dist, -float("inf"))), dim=-1)
        picks.append(last)
    return torch.stack(picks, dim=1)


class Reference:
    """The model of one configuration on the weights ``params`` (a flat
    dict: the published names, float32 tensors; the ``running_*`` buffers
    are updated in place in train mode).  ``train()`` / ``eval()`` as a
    module's."""

    def __init__(self, model_cfg: Dict, params: Dict[str, torch.Tensor]):
        self.cfg = model_cfg
        self.p = params
        self.training = False
        self.calibrate = False
        self.record = False
        self.sites: List[Tuple[int, int, int, int, int, str]] = []

    def train(self, mode: bool = True) -> "Reference":
        self.training = mode
        return self

    def eval(self) -> "Reference":
        return self.train(False)

    # ---- layers

    def linear(self, name, x):
        y = x @ self.p[f"{name}.weight"].t()
        b = self.p.get(f"{name}.bias")
        return y if b is None else y + b

    def mlp2(self, name, x):
        return self.linear(f"{name}.2", torch.relu(self.linear(f"{name}.0", x)))

    def bn(self, name, x):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        rm, rv = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        if not self.training:
            return (x - rm) * torch.rsqrt(rv + EPS) * w + b
        flat = x.reshape(-1, x.shape[-1])
        n = flat.shape[0]
        mean = flat.sum(dim=0) / n
        var = torch.square(flat - mean).sum(dim=0) / n
        with torch.no_grad():
            m = 1.0 if self.calibrate else MOMENTUM
            rm.copy_((1 - m) * rm + m * mean)
            rv.copy_((1 - m) * rv + m * var * (n / max(n - 1, 1)))
            if not self.calibrate:
                self.p[f"{name}.num_batches_tracked"].add_(1)
        return (x - mean) * torch.rsqrt(var + EPS) * w + b

    def attention(self, xyz_q, kv_xyz, q, K, V, delta, gamma, k, k_glob=None, v_glob=None):
        """kNN vector attention, (B, Nq, D), in blocks of query rows."""
        B, Nq, M = xyz_q.shape[0], xyz_q.shape[1], kv_xyz.shape[1]
        D = self.p[f"{gamma}.2.weight"].shape[0]
        k = min(k, M)
        if self.record:
            mode = "pos_only" if q is None else "global" if k_glob is not None else "featured"
            self.sites.append((B, Nq, M, k, D, mode))
        out = []
        for s in range(0, Nq, CHUNK):
            xq = xyz_q[:, s:s + CHUNK]
            qs = None if q is None else q[:, s:s + CHUNK]
            idx = knn(xq, kv_xyz, k)
            pos = self.mlp2(delta, xq[:, :, None, :] - gather(kv_xyz, idx))
            if qs is None:
                logits, value = self.mlp2(gamma, pos), pos
            else:
                logits = self.mlp2(gamma, qs[:, :, None, :] - gather(K, idx) + pos)
                value = gather(V, idx) + pos
            if k_glob is not None:
                lg = self.mlp2(gamma, qs - k_glob[:, None, :])
                logits = torch.cat([logits, lg[:, :, None, :]], dim=2)
                vg = v_glob[:, None, None, :].expand(-1, xq.shape[1], 1, -1)
                value = torch.cat([value, vg], dim=2)
            out.append((torch.softmax(logits, dim=2) * value).sum(dim=2))
        return torch.cat(out, dim=1)

    def transformer(self, name, xyz, feats, k, group_all=False):
        if group_all:
            pos = self.mlp2(f"{name}.fc_delta", xyz[:, :, None, :] - xyz[:, None, :, :])
            q, kk, v = (self.linear(f"{name}.{w}", feats) for w in ("w_qs", "w_ks", "w_vs"))
            logits = self.mlp2(f"{name}.fc_gamma", q[:, :, None, :] - kk[:, None, :, :] + pos)
            res = (torch.softmax(logits, dim=-2) * (v[:, None, :, :] + pos)).sum(dim=-2) + feats
        elif feats is None:
            res = self.attention(xyz, xyz, None, None, None, f"{name}.fc_delta",
                                 f"{name}.fc_gamma", k)
        else:
            q = self.linear(f"{name}.w_qs", feats)
            K, V = self.linear(f"{name}.w_ks", feats), self.linear(f"{name}.w_vs", feats)
            res = self.attention(xyz, xyz, q, K, V, f"{name}.fc_delta", f"{name}.fc_gamma",
                                 k) + feats
        return self.bn(f"{name}.bn", res)

    def elementwise(self, name, x):
        h = torch.relu(self.bn(f"{name}.bn1", self.linear(f"{name}.conv1", x)))
        h = torch.relu(self.bn(f"{name}.bn2", self.linear(f"{name}.conv2", h)))
        return self.bn(f"{name}.bn3", x + h)

    def attentive_set_abstraction(self, sa, xyz, points, npoint, k):
        idx = furthest_point_sample(xyz.detach(), npoint)
        new_xyz = gather(xyz.detach(), idx)
        centre = gather(points, idx)
        # the position encoding is (neighbour - centre), blocks.py:295
        nq, nkv = -new_xyz, -xyz
        K, V = self.linear(f"{sa}.w_ks", points), self.linear(f"{sa}.w_vs", points)
        res1 = self.attention(nq, nkv, self.linear(f"{sa}.w_qs", centre), K, V,
                              f"{sa}.fc_delta1", f"{sa}.fc_gamma1", k)
        h = torch.relu(self.bn(f"{sa}.bn1", self.linear(f"{sa}.conv1", res1)))
        res1 = self.bn(f"{sa}.bnorm0", res1 + self.linear(f"{sa}.conv2", h))
        K, V = self.linear(f"{sa}.w_ks2", points), self.linear(f"{sa}.w_vs2", points)
        res2 = self.attention(nq, nkv, self.linear(f"{sa}.w_qs2", res1), K, V,
                              f"{sa}.fc_delta1", f"{sa}.fc_gamma2", k)
        out = self.bn(f"{sa}.bnorm1", res1 + res2) + centre
        return new_xyz, self.bn(f"{sa}.bnorm2", out)

    def maxpool_set_abstraction(self, sa, xyz, points, npoint, k):
        idx = furthest_point_sample(xyz.detach(), npoint)
        new_xyz = gather(xyz, idx)
        points = self.linear(f"{sa}.fc1", points)
        centre = gather(points, idx)
        h = torch.relu(self.bn(f"{sa}.bn1", self.linear(f"{sa}.conv1", points)))
        h = torch.relu(self.bn(f"{sa}.bn2", self.linear(f"{sa}.conv2", h)))
        points = points + h
        grouped = gather(points, knn(new_xyz.detach(), xyz.detach(), k))
        return new_xyz, self.bn(f"{sa}.bn", centre + torch.amax(grouped, dim=2))

    # ---- networks

    def encode(self, net, xyz, has_features):
        """{'z': (B, D), 'anchors': (B, A, 3), 'anchor_feats': (B, A, D)}."""
        enc, kind = self.cfg["encoder_kwargs"], self.cfg["encoder"]
        name = f"{net}.encoder"
        npoints, nn_ = enc["npoints_per_layer"], enc["nneighbor"]
        feats = None
        if has_features:
            feats, xyz = xyz[:, :, 3:], xyz[:, :, :3]
        if kind == "pointransformer":
            if feats is not None:
                feats = self.linear(f"{name}.enc_sdf", feats)
            feats = self.transformer(f"{name}.transformer_begin", xyz, feats,
                                     enc["nneighbor_reduced"])
            for i in range(len(npoints) - 1):
                xyz, feats = self.attentive_set_abstraction(
                    f"{name}.transition_downs.{i}.sa", xyz, feats, npoints[i + 1],
                    min(nn_, npoints[i]))
                feats = self.elementwise(f"{name}.elementwise_extras.{i}", feats)
                feats = self.transformer(f"{name}.transformer_downs.{i}", xyz, feats,
                                         min(nn_, npoints[i + 1]))
                if i == 0 and enc["d_reduced"] != enc["d_transformer"]:
                    feats = self.linear(f"{name}.fc1", feats)
                feats = self.elementwise(f"{name}.elementwise.{i}", feats)
            group_all = enc.get("full_SA", False)
        else:
            feats = self.mlp2(f"{name}.fc_begin", xyz if feats is None else feats)
            for i in range(len(npoints) - 1):
                xyz, feats = self.maxpool_set_abstraction(
                    f"{name}.transition_downs.{i}.sa", xyz, feats, npoints[i + 1],
                    min(nn_, npoints[i]))
                feats = self.elementwise(f"{name}.elementwise.{i}", feats)
            group_all = True
        for j in range(enc["nfinal_transformers"]):
            feats = self.transformer(f"{name}.final_transformers.{j}", xyz, feats, 2 * nn_,
                                     group_all=group_all)
            feats = self.elementwise(f"{name}.final_elementwise.{j}", feats)
        z = self.mlp2(f"{name}.fc_middle", feats.amax(dim=1))
        return {"z": z, "anchors": xyz, "anchor_feats": feats}

    def decode(self, net, xyz_q, enc):
        name = f"{net}.decoder"
        dec = self.cfg["decoder_kwargs"]
        ct = f"{name}.ct1"
        z, feats = enc["z"], enc["anchor_feats"]
        q = self.linear(f"{ct}.w_qs", z)[:, None, :].expand(-1, xyz_q.shape[1], -1)
        lat = self.attention(xyz_q, enc["anchors"], q, self.linear(f"{ct}.w_ks", feats),
                             self.linear(f"{ct}.w_vs", feats), f"{ct}.fc_delta",
                             f"{ct}.fc_gamma", dec["nneigh"],
                             k_glob=self.linear(f"{ct}.w_k_global", z),
                             v_glob=self.linear(f"{ct}.w_v_global", z))
        net_ = self.linear(f"{name}.init_enc", lat)
        for i in range(dec.get("n_blocks", 5)):
            x = net_ + self.linear(f"{name}.fc_c.{i}", lat)
            dx = self.linear(f"{name}.blocks.{i}.fc_1",
                             torch.relu(self.linear(f"{name}.blocks.{i}.fc_0", torch.relu(x))))
            net_ = x + dx
        return self.linear(f"{name}.fc_out", torch.relu(net_))

    # ---- the arbitrary-pose composition (model/flow_arbitrary.py)

    def canonicalize(self, points, surf_src, twice: Optional[bool] = None):
        """-> (canonical space points, canonical surface).  The published
        model runs the canonicalising net once per point set (``twice``,
        the default); ``twice=False`` encodes the surface once, the least
        work the result needs (the operation counts)."""
        net = "model_canonicalize"
        enc = self.encode(net, surf_src, False)
        space = self.decode(net, points, enc)
        if twice is None or twice:
            enc = self.encode(net, surf_src, False)
        return space, self.decode(net, surf_src, enc)

    def deform(self, space_cano, surf_cano, surf_tgt, mask):
        net = "model_deform"
        cond = torch.cat([surf_cano, surf_tgt, mask], dim=-1)
        return self.decode(net, space_cano, self.encode(net, cond, True))

    def predict(self, points, surface_samples_inputs, twice: Optional[bool] = None):
        """The deformed query points for [source | masked target | mask]
        (B, N, 7) conditioning."""
        s = surface_samples_inputs
        space, surf = self.canonicalize(points, s[..., 0:3], twice)
        return self.deform(space, surf, s[..., 3:6], s[..., 6:7])


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 * mean squared deformation error (``model/utils.py:8-11``)."""
    delta = pred - target
    return torch.mean(0.5 * torch.sum(delta * delta, dim=-1))


class Adam:
    """``torch.optim.Adam``'s update (betas 0.9 / 0.999, eps 1e-8, no
    weight decay), written out."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: Optional[float] = None) -> None:
        """One update, at ``lr`` (the rate given at construction if None)."""
        lr = self.lr if lr is None else lr
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))
