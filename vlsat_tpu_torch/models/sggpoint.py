"""The SGGpoint family (counterpart of ``vlsat_tpu/models/sggpoint.py``):
a DGCNN point backbone and EdgeGCN graph reasoning, as the VL-SAT
dual-branch model (``SGGpoint``: cross-attention, CLIP-text cosine
classifiers) and as the plain baseline (``SGGpointBaseline``).

The kNN EdgeConv runs batched over padded (B, N, P, C) point sets
(``ops.dgcnn``); GCNConv is the scatter propagation of ``ops.gcn``; the
BatchNorms over concatenated nodes, points or edges are masked BatchNorms
over the padded batch.  Submodules are named as the flax tree names them,
so ``interop.from_flax`` carries the weights with its generic rules.  Torch
needs the input width that flax infers, the point channels
(``point_channels``); the 2D features are ``dim`` wide.  Neither
model reaches a kernel of ``ops.kernels``: the JAX models reach no Pallas
call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from vlsat_tpu_torch.models.layers import AdapterModel, Dropout, MaskedBatchNorm
from vlsat_tpu_torch.models.mmgnet import TripletProjector, spatial_features
from vlsat_tpu_torch.models.transformer import DistanceBiasMLP, MultiHeadAttention
from vlsat_tpu_torch.ops.attention import pairwise_distance_bias
from vlsat_tpu_torch.ops.descriptor import edge_descriptor
from vlsat_tpu_torch.ops.dgcnn import graph_feature
from vlsat_tpu_torch.ops.gcn import gcn_propagate
from vlsat_tpu_torch.ops.graph import gather_edge_endpoints, scatter_edges_to_nodes
from vlsat_tpu_torch.ops.norm import safe_normalize
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.train.losses import (cosine_mimic_loss, cross_entropy,
                                          dynamic_rel_weights, rel_mimic_l1, weighted_bce)

_STAGES = (64, 64, 128, 256)  # EdgeConv widths (reference SGGpoint/model.py:97-128)


class DGCNN(nn.Module):
    """Four EdgeConv stages (64, 64, 128, 256: a bias-free dense over
    [x_j - x_i, x_i] of the k nearest points, a masked BatchNorm over the
    valid nodes' (P, k) rows, leaky ReLU 0.2, max over k), then ``conv5``
    from their concatenation to ``embeddings``: (B, N, P, C) -> (B, N, P,
    embeddings).  ``k`` is capped at P, as the JAX models cap it."""

    def __init__(self, in_channels: int = 3, embeddings: int = 768, k: int = 20):
        super().__init__()
        self.k = k
        for i, out in enumerate(_STAGES, start=1):
            self.add_module(f"conv{i}_fc", nn.Linear(2 * in_channels, out, bias=False))
            self.add_module(f"conv{i}_bn", MaskedBatchNorm(out))
            in_channels = out
        self.conv5_fc = nn.Linear(sum(_STAGES), embeddings, bias=False)
        self.conv5_bn = MaskedBatchNorm(embeddings)

    def forward(self, pts, node_mask):
        k = min(self.k, pts.shape[-2])
        x, feats = pts, []
        for i in range(1, len(_STAGES) + 1):
            h = getattr(self, f"conv{i}_fc")(graph_feature(x, k=k))    # (B, N, P, k, C)
            h = getattr(self, f"conv{i}_bn")(
                h, node_mask[:, :, None, None].expand(h.shape[:-1]))
            x = F.leaky_relu(h, 0.2).amax(dim=-2)
            feats.append(x)
        h = self.conv5_fc(torch.cat(feats, dim=-1))
        h = self.conv5_bn(h, node_mask[:, :, None].expand(h.shape[:-1]))
        return F.leaky_relu(h, 0.2)


class EdgeGCN(nn.Module):
    """Node/edge co-evolution layer (reference SGGpoint/model.py:136-206):
    an edge gate from the mean of the projected edges at both endpoints,
    two GCN propagations of the nodes, a node gate on the gathered
    endpoints of the updated nodes, and the edge MLP.  x (B, N, dim), e (B,
    E, dim) -> (x', e'), both dim wide.  Both gates and Dropout 0.5, as
    every JAX caller has them (``attn_edge``/``attn_node``/``dropout`` keep
    their defaults)."""

    def __init__(self, dim: int = 512):
        super().__init__()
        mid = dim // 2
        self.edge_attentionND = nn.Linear(dim, mid)
        self.node_GConv1_fc = nn.Linear(dim, mid)
        self.node_GConv2_fc = nn.Linear(mid, dim)
        self.node_attentionND = nn.Linear(dim, mid)
        self.node_indicator_reduction = nn.Linear(2 * mid, mid)
        self.edge_MLP1_fc = nn.Linear(dim, mid)
        self.edge_MLP2_fc = nn.Linear(mid, dim)
        self.drop = Dropout(0.5)

    def forward(self, x, e, edge_index, edge_mask, rng=None):
        n = x.shape[1]
        ind = self.edge_attentionND(e)
        row = scatter_edges_to_nodes(ind, edge_index, edge_mask, n, aggr="mean", target=0)
        col = scatter_edges_to_nodes(ind, edge_index, edge_mask, n, aggr="mean", target=1)
        edge_gate = torch.sigmoid(row * col)
        h = torch.relu(self.node_GConv1_fc(gcn_propagate(x, edge_index, edge_mask))) * edge_gate
        h = self.drop(h, rng)
        x_new = torch.relu(self.node_GConv2_fc(gcn_propagate(h, edge_index, edge_mask)))
        ni, nj = gather_edge_endpoints(torch.relu(self.node_attentionND(x_new)), edge_index)
        node_gate = torch.sigmoid(self.node_indicator_reduction(torch.cat([ni, nj], -1)))
        he = self.drop(torch.relu(self.edge_MLP1_fc(e)), rng) * node_gate
        return x_new, torch.relu(self.edge_MLP2_fc(he))


class EdgeMLPHead(nn.Module):
    """Sigmoid relation head (reference model.py:309-325): bias-free
    Linear, masked BatchNorm over valid edges, leaky ReLU 0.2, Dropout 0.5,
    bias-free Linear."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        mid = in_features // 2
        self.edge_linear1 = nn.Linear(in_features, mid, bias=False)
        self.edge_bn = MaskedBatchNorm(mid)
        self.drop = Dropout(0.5)
        self.edge_linear2 = nn.Linear(mid, num_classes, bias=False)

    def forward(self, e, edge_mask, rng=None):
        h = F.leaky_relu(self.edge_bn(self.edge_linear1(e), edge_mask), 0.2)
        return torch.sigmoid(self.edge_linear2(self.drop(h, rng)))


class MMEdgeGCN(nn.Module):
    """Dual-branch EdgeGCN (reference model.py:208-291): distance-biased
    self-attention over the 3D nodes, cross-attention of the 2D nodes onto
    them, an EdgeGCN per branch, and the 2D edges' cross-attention onto the
    3D edges over each scene's (E x E) valid pairs."""

    def __init__(self, dim_node: int = 512, dim_edge: int = 512, num_heads: int = 8):
        super().__init__()
        self.self_attn_fc = DistanceBiasMLP(num_heads)
        self.self_attn = MultiHeadAttention(num_heads, dim_node)
        self.cross_attn = MultiHeadAttention(num_heads, dim_node)
        self.edgegcn_3d = EdgeGCN(dim_node)
        self.edgegcn_2d = EdgeGCN(dim_node)
        self.cross_attn_rel = MultiHeadAttention(num_heads, dim_edge)

    def forward(self, f3d, f2d, e3d, e2d, edge_index, obj_mask, edge_mask, obj_center,
                rng=None):
        mask = obj_mask[:, None, None, :] & obj_mask[:, None, :, None]
        emask = edge_mask[:, None, None, :] & edge_mask[:, None, :, None]
        bias = self.self_attn_fc(pairwise_distance_bias(obj_center.detach()))
        f3d = self.self_attn(f3d, f3d, f3d, mask=mask, bias=bias, rng=rng)
        f2d = self.cross_attn(f2d, f3d, f3d, mask=mask, bias=bias, rng=rng)
        f3d, e3d = self.edgegcn_3d(f3d, e3d, edge_index, edge_mask, rng)
        f2d, e2d = self.edgegcn_2d(f2d, e2d, edge_index, edge_mask, rng)
        e2d = self.cross_attn_rel(e2d, e3d, e3d, mask=emask, rng=rng)
        return f3d, e3d, f2d, e2d


def _edge_init(node_feats, edge_index):
    """[subject, object - subject] per edge (reference model.py:347-359)."""
    fi, fj = gather_edge_endpoints(node_feats, edge_index)
    return torch.cat([fi, fj - fi], dim=-1)


@dataclasses.dataclass(frozen=True)
class SGGpointConfig:
    """The fields of ``vlsat_tpu.models.sggpoint.SGGpointConfig``, with the
    same defaults, plus the input width flax infers from the batch:
    ``point_channels`` (3, plus 3 for each of RGB and normals).  The 2D
    features are ``dim`` wide."""

    num_obj_classes: int = 160
    num_rel_classes: int = 26
    dim: int = 512
    num_heads: int = 8
    use_spatial: bool = True
    knn_k: int = 20
    point_channels: int = 3


class SGGpoint(nn.Module):
    """VL-SAT SGGpoint (reference model.py:347-692).  ``obj_text_features``
    seeds ``obj_classifier_3d``/``_2d`` through ``init_parameters``, as
    JAX's ``_text_kernel_init`` does.  The attention residuals need nodes
    ``dim`` wide: without the spatial features the 3D nodes are ``dim - 8``
    wide; JAX fails inside the attention, and this model refuses it when
    built.  The 2D features are ``dim`` wide (the registry refuses another
    ``clip_feat_dim``)."""

    BACKBONE = 768  # the DGCNN embedding of the reference (model.py:373)

    def __init__(self, cfg: SGGpointConfig = SGGpointConfig(),
                 obj_text_features: Optional[np.ndarray] = None):
        super().__init__()
        d = cfg.dim
        if not cfg.use_spatial:
            raise ValueError(f"the 3D node features are {d - 8} wide, not dim {d} "
                             "(use_spatial=False): the attention residuals cannot add them")
        self.cfg = cfg
        self.obj_text_features = obj_text_features
        self.text_classifiers = ("obj_classifier_3d", "obj_classifier_2d")
        self.backbone = DGCNN(cfg.point_channels, self.BACKBONE, cfg.knn_k)
        self.mlp_3d = nn.Linear(self.BACKBONE, d - 8)
        self.edge_mlp_3d = nn.Linear(2 * d, d - 11)
        self.clip_adapter = AdapterModel(d, alpha=0.5)
        self.edge_mlp_2d = nn.Linear(2 * d, d - 11)
        self.edge_gcn = MMEdgeGCN(d, d, cfg.num_heads)
        self.obj_mlp_3d = nn.Linear(2 * d, d)
        self.obj_mlp_2d = nn.Linear(2 * d, d)
        self.rel_mlp_3d = nn.Linear(2 * d, d)
        self.rel_mlp_2d = nn.Linear(2 * d, d)
        self.obj_logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.obj_classifier_3d = nn.Linear(d, cfg.num_obj_classes, bias=False)
        self.obj_classifier_2d = nn.Linear(d, cfg.num_obj_classes, bias=False)
        self.rel_classifier_3d = EdgeMLPHead(d, cfg.num_rel_classes)
        self.rel_classifier_2d = EdgeMLPHead(d, cfg.num_rel_classes)
        self.triplet_projector_3d = TripletProjector(3 * d)
        self.triplet_projector_2d = TripletProjector(3 * d)

    def forward(self, batch: SceneBatch, istrain: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = self.backbone(batch.obj_points, batch.obj_mask)
        f3d = x.amax(dim=2)                                     # pool the points
        mimic_3d = f3d[..., :512]
        f3d = torch.cat([self.mlp_3d(f3d), spatial_features(batch.descriptor)], dim=-1)

        ed = edge_descriptor(batch.descriptor, batch.edge_index).detach()
        e3d = torch.cat([self.edge_mlp_3d(_edge_init(f3d, batch.edge_index)), ed], dim=-1)
        obj_2d = self.clip_adapter(batch.obj_2d_feats).detach()
        e2d = torch.cat([self.edge_mlp_2d(_edge_init(obj_2d, batch.edge_index)), ed], dim=-1)

        g3, ge3, g2, ge2 = self.edge_gcn(f3d, obj_2d, e3d, e2d, batch.edge_index,
                                         batch.obj_mask, batch.edge_mask,
                                         batch.descriptor[..., :3], rng)
        g3 = self.obj_mlp_3d(torch.cat([f3d, g3], -1))
        g2 = self.obj_mlp_2d(torch.cat([obj_2d, g2], -1))
        ge3 = self.rel_mlp_3d(torch.cat([e3d, ge3], -1))
        ge2 = self.rel_mlp_2d(torch.cat([e2d, ge2], -1))

        scale = torch.exp(self.obj_logit_scale)
        out = {"obj_logits_3d": scale * self.obj_classifier_3d(safe_normalize(g3)),
               "obj_logits_2d": scale * self.obj_classifier_2d(safe_normalize(g2)),
               "rel_cls_3d": self.rel_classifier_3d(ge3, batch.edge_mask, rng),
               "rel_cls_2d": self.rel_classifier_2d(ge2, batch.edge_mask, rng)}
        if istrain:
            def pair(g, ge, projector):
                gi, gj = gather_edge_endpoints(g, batch.edge_index)
                return projector(torch.cat([gi, gj, ge], -1), rng)

            out.update(obj_feature_3d_mimic=mimic_3d, obj_features_2d_mimic=obj_2d,
                       edge_feature_3d_dis=pair(g3, ge3, self.triplet_projector_3d),
                       edge_feature_2d_dis=pair(g2, ge2, self.triplet_projector_2d),
                       logit_scale=scale)
        return out


def sggpoint_loss(outputs, batch: SceneBatch):
    """Reference model.py:600-626: 0.1 (obj3d + obj2d) + 3 (rel3d + rel2d)
    + 0.1 (mimic + rel_mimic_2d), DYNAMIC weights."""
    obj3 = cross_entropy(outputs["obj_logits_3d"], batch.gt_class, batch.obj_mask)
    obj2 = cross_entropy(outputs["obj_logits_2d"], batch.gt_class, batch.obj_mask)
    w = dynamic_rel_weights(batch.gt_rels, batch.edge_mask)
    rel3 = weighted_bce(outputs["rel_cls_3d"], batch.gt_rels, w, batch.edge_mask)
    rel2 = weighted_bce(outputs["rel_cls_2d"], batch.gt_rels, w, batch.edge_mask)
    mimic = cosine_mimic_loss(outputs["obj_feature_3d_mimic"],
                              outputs["obj_features_2d_mimic"], batch.obj_mask)
    if batch.rel_text_feat is not None:
        rm = rel_mimic_l1(outputs["edge_feature_2d_dis"], batch.rel_text_feat, batch.edge_mask)
    else:
        rm = obj3.new_zeros(())
    total = 0.1 * (obj3 + obj2) + 3.0 * (rel3 + rel2) + 0.1 * (mimic + rm)
    return total, dict(loss=total, obj_loss=obj3, obj_loss_2d=obj2, rel_loss=rel3,
                       rel_loss_2d=rel2, mimic_loss=mimic, rel_mimic_loss_2d=rm)


class SGGpointBaseline(nn.Module):
    """The plain SGGpoint (reference SGGpoint/baseline.py:267-390): the
    DGCNN backbone at ``dim``, one EdgeGCN, a NodeMLP head (bias-free
    Linear, masked BatchNorm, leaky ReLU 0.2, Dropout 0.5, bias-free Linear)
    and an ``EdgeMLPHead``.  Both branches' outputs are the one 3D head."""

    def __init__(self, cfg: SGGpointConfig = SGGpointConfig()):
        super().__init__()
        d, mid = cfg.dim, cfg.dim // 2
        self.cfg = cfg
        self.backbone = DGCNN(cfg.point_channels, d, cfg.knn_k)
        self.edge_proj = nn.Linear(2 * d, d)
        self.edge_gcn = EdgeGCN(d)
        self.node_linear1 = nn.Linear(d, mid, bias=False)
        self.node_bn = MaskedBatchNorm(mid)
        self.drop = Dropout(0.5)
        self.node_linear2 = nn.Linear(mid, cfg.num_obj_classes, bias=False)
        self.rel_classifier = EdgeMLPHead(d, cfg.num_rel_classes)

    def forward(self, batch: SceneBatch, istrain: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        f = self.backbone(batch.obj_points, batch.obj_mask).amax(dim=2)
        e = self.edge_proj(_edge_init(f, batch.edge_index))
        f, e = self.edge_gcn(f, e, batch.edge_index, batch.edge_mask, rng)
        h = self.node_bn(self.node_linear1(f), batch.obj_mask)
        obj_logits = self.node_linear2(self.drop(F.leaky_relu(h, 0.2), rng))
        rel_cls = self.rel_classifier(e, batch.edge_mask, rng)
        return {"obj_logits_3d": obj_logits, "obj_logits_2d": obj_logits,
                "rel_cls_3d": rel_cls, "rel_cls_2d": rel_cls}


def sggpoint_baseline_loss(outputs, batch: SceneBatch):
    """0.1 obj + rel, DYNAMIC weights (reference baseline.py)."""
    obj = cross_entropy(outputs["obj_logits_3d"], batch.gt_class, batch.obj_mask)
    w = dynamic_rel_weights(batch.gt_rels, batch.edge_mask)
    rel = weighted_bce(outputs["rel_cls_3d"], batch.gt_rels, w, batch.edge_mask)
    total = 0.1 * obj + rel
    return total, dict(loss=total, obj_loss=obj, rel_loss=rel)
