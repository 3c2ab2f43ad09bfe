"""Model-zoo variants: the 3D-only VL-SAT, SGFN and SGPN baselines
(counterpart of ``vlsat_tpu/models/variants.py``).

  * ``MMGNetSingle``: the flagship's 3D branch alone (PointNet -> mlp_3d ++
    spatial -> ``MMGSingle`` -> sigmoid relation head + cosine object
    classifier); ``istrain=True`` adds ``triplet_projector_3d``'s projected
    pair features for the rel-mimic loss.
  * ``SGFN``: PointNet(dim_node - 8) ++ spatial, a 256-wide edge encoder,
    per layer distance-biased self-attention (8 heads) then a
    ``GraphEdgeAttenNetwork``; log-softmax object head.
  * ``SGPN``: no graph network; the relation encoder reads the per-edge
    union point clouds ``batch.rel_points`` (point channels + 1 mask
    channel), which the dataset emits with ``with_union_points`` and a
    client of ``serving.BatchedServer`` sends with each scene.

Each reports its one branch under both the "3d" and the "2d" keys, as in
JAX.  Module names follow the flax tree, so ``interop.from_flax`` bridges
the JAX weights leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vlsat_tpu_torch.models.gnn import GraphEdgeAttenNetwork
from vlsat_tpu_torch.models.layers import Dropout, MaskedBatchNorm, PointNetEncoder
from vlsat_tpu_torch.models.mmg import MMGSingle
from vlsat_tpu_torch.models.mmgnet import (MMGNetConfig, RelPredictor, TripletProjector,
                                           spatial_features)
from vlsat_tpu_torch.models.transformer import (FLAX_LN_EPS, DistanceBiasMLP,
                                               MultiHeadAttention, set_layer_norm_eps)
from vlsat_tpu_torch.ops.attention import pairwise_distance_bias
from vlsat_tpu_torch.ops.descriptor import edge_descriptor
from vlsat_tpu_torch.ops.graph import EdgeRows, gather_edge_endpoints, unpack_edges
from vlsat_tpu_torch.ops.norm import safe_normalize
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.utils import profiling


def _both_branches(obj_logits, rel_cls) -> Dict[str, torch.Tensor]:
    return {"obj_logits_3d": obj_logits, "rel_cls_3d": rel_cls,
            "obj_logits_2d": obj_logits, "rel_cls_2d": rel_cls}


class ObjClsHead(nn.Module):
    """PointNetCls head (variants.py:41-54): fc1(512)-relu / fc2(256)-
    dropout-relu / fc3, then log-softmax."""

    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.3):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 512)
        self.fc2 = nn.Linear(512, 256)
        self.drop = Dropout(dropout)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(self, x, rng=None):
        x = torch.relu(self.drop(self.fc2(torch.relu(self.fc1(x))), rng))
        return torch.log_softmax(self.fc3(x), dim=-1)


class MMGNetSingle(nn.Module):
    """3D-only VL-SAT (variants.py:57-108).  It reads ``use_spatial`` of
    ``MMGNetConfig`` and none of the in21k switches; without the spatial
    features the graph stack's first layer takes dim_node - 8 wide nodes."""

    def __init__(self, cfg: MMGNetConfig = MMGNetConfig(),
                 obj_text_features: Optional[np.ndarray] = None):
        super().__init__()
        self.cfg = cfg
        self.obj_text_features = obj_text_features
        self.text_classifiers = ("obj_predictor_3d",)
        self.obj_encoder = PointNetEncoder(cfg.point_channels, cfg.point_feature_size)
        self.mlp_3d_fc = nn.Linear(cfg.point_feature_size, cfg.dim_node - 8)
        self.mlp_3d_bn = MaskedBatchNorm(cfg.dim_node - 8)
        self.mlp_3d_drop = Dropout(0.1)
        self.rel_encoder_3d = PointNetEncoder(11, cfg.dim_edge)
        self.mmg = MMGSingle(dim_node=cfg.dim_node, dim_edge=cfg.dim_edge,
                             dim_atten=cfg.dim_atten, num_heads=cfg.num_heads,
                             depth=cfg.depth, aggr=cfg.gcn_aggr,
                             dropout_atten=cfg.dropout_atten, use_edge=cfg.use_gcn_edge,
                             dim_in=cfg.dim_node - (0 if cfg.use_spatial else 8))
        self.rel_predictor_3d = RelPredictor(cfg.dim_edge, cfg.num_rel_classes,
                                             multi_label=cfg.multi_rel_outputs)
        self.obj_logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.obj_predictor_3d = nn.Linear(cfg.dim_node, cfg.num_obj_classes)
        self.triplet_projector_3d = TripletProjector(2 * cfg.dim_node + cfg.dim_edge)

    def forward(self, batch: SceneBatch, istrain: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        f = self.obj_encoder(batch.obj_points)
        f = self.mlp_3d_drop(torch.relu(self.mlp_3d_bn(self.mlp_3d_fc(f), batch.obj_mask)),
                             rng)
        if self.cfg.use_spatial:
            f = torch.cat([f, spatial_features(batch.descriptor)], dim=-1)
        ed = edge_descriptor(batch.descriptor, batch.edge_index).detach()
        e = self.rel_encoder_3d(ed[..., None, :])
        f3d, e3d = self.mmg(f, e, batch.edge_index, batch.edge_mask, rng)
        rel_cls = self.rel_predictor_3d(e3d, rng)
        scale = torch.exp(self.obj_logit_scale)
        out = _both_branches(scale * self.obj_predictor_3d(safe_normalize(f3d)), rel_cls)
        if istrain:
            fi, fj = gather_edge_endpoints(f3d, batch.edge_index)
            out.update(edge_feature_3d_dis=self.triplet_projector_3d(
                torch.cat([fi, fj, e3d], dim=-1), rng), logit_scale=scale)
        return out


class GraphEdgeAttenNetworkLayers(nn.Module):
    """Per layer: distance-biased node self-attention with 8 heads (fixed,
    as in the reference) then a ``GraphEdgeAttenNetwork`` with
    ``num_heads``; ReLU + dropout after layer i when i < L - 1 or L == 1
    (variants.py:111-143)."""

    def __init__(self, dim_node: int = 512, dim_edge: int = 256, dim_atten: int = 256,
                 num_layers: int = 2, num_heads: int = 8, aggr: str = "max",
                 dropout_atten: Optional[float] = 0.5, use_edge: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.self_attn_fc = DistanceBiasMLP(8)
        for i in range(num_layers):
            self.add_module(f"self_attn_{i}", MultiHeadAttention(8, dim_node))
            self.add_module(f"gconv_{i}", GraphEdgeAttenNetwork(
                num_heads, dim_node, dim_edge, dim_atten, aggr=aggr,
                dropout_atten=dropout_atten, use_edge=use_edge))
        self.drop = Dropout(dropout_atten or 0.0)

    def forward(self, x, e, edge_index, obj_mask, edge_mask, obj_center, rng=None):
        node_mask = obj_mask[:, None, None, :] & obj_mask[:, None, :, None]
        bias = self.self_attn_fc(pairwise_distance_bias(obj_center.detach()))
        for i in range(self.num_layers):
            x = getattr(self, f"self_attn_{i}")(x, x, x, mask=node_mask, bias=bias, rng=rng)
            x, e = getattr(self, f"gconv_{i}")(x, e, edge_index, edge_mask, rng)
            if i < self.num_layers - 1 or self.num_layers == 1:
                x = self.drop(torch.relu(x), rng)
                e = self.drop(torch.relu(e), rng)
        return x, e


@dataclasses.dataclass(frozen=True)
class SGFNConfig:
    """``vlsat_tpu.models.variants.SGFNConfig`` plus ``point_channels`` and
    ``ln_eps`` (as ``MMGNetConfig``'s)."""

    num_obj_classes: int = 160
    num_rel_classes: int = 26
    dim_node: int = 512
    edge_feature_size: int = 256
    dim_atten: int = 256
    num_heads: int = 8
    depth: int = 2
    gcn_aggr: str = "max"
    dropout_atten: float = 0.5
    use_spatial: bool = True
    use_gcn_edge: bool = True
    multi_rel_outputs: bool = True
    point_channels: int = 3
    ln_eps: float = FLAX_LN_EPS


class SGFN(nn.Module):
    """SceneGraphFusion baseline (variants.py:161-191)."""

    def __init__(self, cfg: SGFNConfig = SGFNConfig()):
        super().__init__()
        self.cfg = cfg
        self.obj_encoder = PointNetEncoder(cfg.point_channels,
                                           cfg.dim_node - (8 if cfg.use_spatial else 0))
        self.rel_encoder = PointNetEncoder(11, cfg.edge_feature_size)
        self.gcn = GraphEdgeAttenNetworkLayers(
            dim_node=cfg.dim_node, dim_edge=cfg.edge_feature_size, dim_atten=cfg.dim_atten,
            num_layers=cfg.depth, num_heads=cfg.num_heads, aggr=cfg.gcn_aggr,
            dropout_atten=cfg.dropout_atten, use_edge=cfg.use_gcn_edge)
        self.obj_predictor = ObjClsHead(cfg.dim_node, cfg.num_obj_classes)
        self.rel_predictor = RelPredictor(cfg.edge_feature_size, cfg.num_rel_classes,
                                          multi_label=cfg.multi_rel_outputs)
        set_layer_norm_eps(self, cfg.ln_eps)

    def forward(self, batch: SceneBatch, istrain: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        f = self.obj_encoder(batch.obj_points)
        if self.cfg.use_spatial:
            f = torch.cat([f, spatial_features(batch.descriptor)], dim=-1)
        ed = edge_descriptor(batch.descriptor, batch.edge_index).detach()
        e = self.rel_encoder(ed[..., None, :])
        f, e = self.gcn(f, e, batch.edge_index, batch.obj_mask, batch.edge_mask,
                        batch.descriptor[..., :3], rng)
        return _both_branches(self.obj_predictor(f, rng), self.rel_predictor(e, rng))


@dataclasses.dataclass(frozen=True)
class SGPNConfig:
    """``vlsat_tpu.models.variants.SGPNConfig`` plus ``point_channels`` (the
    union clouds carry one more, the membership mask) and ``fused_pointnet``
    (both encoders through the fused PointNet kernel in eval mode)."""

    num_obj_classes: int = 160
    num_rel_classes: int = 26
    point_feature_size: int = 512
    edge_feature_size: int = 256
    multi_rel_outputs: bool = True
    point_channels: int = 3
    fused_pointnet: bool = False


class SGPN(nn.Module):
    """Union-point-cloud baseline (variants.py:202-223): reads
    ``batch.rel_points`` (B, E, P, point_channels + 1) and raises
    ``ValueError`` without them.  Its one branch is its 3D branch, so
    ``branch_3d_only`` (the serving mode) changes nothing.  In eval mode
    ``edge_rows`` (``ops.graph.EdgeRows``) makes ``rel_points`` the packed
    rows (R, P, point_channels + 1) it names: the relation encoder and head
    run on them alone and ``rel_cls_*`` is the same dense (B, E, R) tensor.
    The relation encoder runs inside the span ``model.union``
    (``utils.profiling``; rows encoded, points a row, and ``fused``: the
    fused PointNet route taken)."""

    needs_rel_points = True  # a server must ship each scene's union clouds

    def __init__(self, cfg: SGPNConfig = SGPNConfig()):
        super().__init__()
        self.cfg = cfg
        self.obj_encoder = PointNetEncoder(cfg.point_channels, cfg.point_feature_size,
                                           fused=cfg.fused_pointnet)
        self.rel_encoder = PointNetEncoder(cfg.point_channels + 1, cfg.edge_feature_size,
                                           fused=cfg.fused_pointnet)
        self.obj_predictor = ObjClsHead(cfg.point_feature_size, cfg.num_obj_classes)
        self.rel_predictor = RelPredictor(cfg.edge_feature_size, cfg.num_rel_classes,
                                          multi_label=cfg.multi_rel_outputs)

    def forward(self, batch: SceneBatch, istrain: bool = False, branch_3d_only: bool = False,
                rng: Optional[torch.Generator] = None,
                edge_rows: Optional[EdgeRows] = None) -> Dict[str, torch.Tensor]:
        pts = batch.rel_points
        if pts is None:
            raise ValueError("SGPN needs batch.rel_points: enable dataset.with_union_points, or "
                             "serve it through its eval step (or a wrapper that keeps the "
                             "step's union_rows), whose server ships each request's clouds")
        if (edge_rows is not None and self.training) or (edge_rows is None) != (pts.dim() == 4):
            raise ValueError("rel_points are dense (B, E, P, C), or in eval mode packed "
                             f"(R, P, C) with their edge_rows; got {tuple(pts.shape)}")
        f = self.obj_encoder(batch.obj_points)
        with profiling.span("model.union", rows=math.prod(pts.shape[:-2]), points=pts.shape[-2],
                            fused=self.rel_encoder.fused and not self.training):
            e = self.rel_encoder(pts)
        rel_cls = self.rel_predictor(e, rng)
        if edge_rows is not None:
            rel_cls = unpack_edges(rel_cls, edge_rows.src, batch.num_scenes)
        return _both_branches(self.obj_predictor(f, rng), rel_cls)
