"""Teacher/student variant (counterpart of ``vlsat_tpu/models/mmteacher.py``).

A multi-modal teacher fuses the 3D and the adapted 2D node features through
self- and cross-attention and a fusion MLP before its GCN stack; a 3D-only
student runs self-attention before and after a mimic tap, then its own GCN
stack.  The student is the deployed branch and is reported as "3d", the
teacher as "2d".  ``mmteacher_loss`` distils: the student's pre-GNN 512-d
feature mimics the adapted 2D features, its post-attention feature mimics
the teacher's detached fused feature, and both towers' projected pair
features regress the triplet text targets.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vlsat_tpu_torch.models.gnn import GraphEdgeAttenNetwork
from vlsat_tpu_torch.models.layers import (AdapterModel, Dropout, MaskedBatchNorm,
                                           PointNetEncoder)
from vlsat_tpu_torch.models.mmgnet import (MMGNetConfig, RelPredictor, TripletProjector,
                                           spatial_features)
from vlsat_tpu_torch.models.transformer import (DistanceBiasMLP, MultiHeadAttention,
                                               set_layer_norm_eps)
from vlsat_tpu_torch.ops.attention import pairwise_distance_bias
from vlsat_tpu_torch.ops.descriptor import edge_descriptor
from vlsat_tpu_torch.ops.graph import gather_edge_endpoints
from vlsat_tpu_torch.ops.norm import safe_normalize
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.train.losses import (_normalised_lambdas, cosine_mimic_loss,
                                          cross_entropy, dynamic_rel_weights, rel_mimic_l1,
                                          weighted_bce)

Aux = Dict[str, torch.Tensor]


class _GCNStack(nn.Module):
    """``depth`` ``GraphEdgeAttenNetwork`` layers ``gcn_{i}``, ReLU + dropout
    between them (and after the only one when depth == 1)."""

    def __init__(self, dim_node: int = 512, dim_edge: int = 512, dim_atten: int = 256,
                 num_heads: int = 8, depth: int = 2, aggr: str = "max",
                 dropout_atten: float = 0.5, use_edge: bool = True):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"gcn_{i}", GraphEdgeAttenNetwork(
                num_heads, dim_node, dim_edge, dim_atten, aggr=aggr,
                dropout_atten=dropout_atten, use_edge=use_edge))
        self.drop = Dropout(dropout_atten)

    def forward(self, x, e, edge_index, edge_mask, rng=None):
        for i in range(self.depth):
            x, e = getattr(self, f"gcn_{i}")(x, e, edge_index, edge_mask, rng)
            if i < self.depth - 1 or self.depth == 1:
                x, e = self.drop(torch.relu(x), rng), self.drop(torch.relu(e), rng)
        return x, e


class _Core(nn.Module):
    """The distance bias and the GCN stack that both towers share."""

    def __init__(self, dim_node: int = 512, dim_edge: int = 512, dim_atten: int = 256,
                 num_heads: int = 8, depth: int = 2, aggr: str = "max",
                 dropout_atten: float = 0.5, use_edge: bool = True):
        super().__init__()
        self.self_attn_fc = DistanceBiasMLP(num_heads)
        self.gcns = _GCNStack(dim_node, dim_edge, dim_atten, num_heads, depth, aggr,
                              dropout_atten, use_edge)

    def _mask_and_bias(self, obj_mask, obj_center):
        mask = obj_mask[:, None, None, :] & obj_mask[:, None, :, None]
        return mask, self.self_attn_fc(pairwise_distance_bias(obj_center.detach()))


class MMGTeacherCore(_Core):
    """4-way attention, fusion MLP (Linear-ReLU-BN-Dropout-Linear-ReLU-BN)
    and GCN stack (mmteacher.py:66-125); returns (nodes, edges, the fused
    feature detached as the student's mimic target)."""

    def __init__(self, dim_node: int = 512, dim_edge: int = 512, dim_atten: int = 256,
                 num_heads: int = 8, depth: int = 2, aggr: str = "max",
                 dropout_atten: float = 0.5, use_edge: bool = True):
        super().__init__(dim_node, dim_edge, dim_atten, num_heads, depth, aggr,
                         dropout_atten, use_edge)
        for name in ("self_attn_3d", "self_attn_2d", "cross_attn_3d", "cross_attn_2d"):
            self.add_module(name, MultiHeadAttention(num_heads, dim_node))
        self.fusion_fc0 = nn.Linear(4 * dim_node, 2 * dim_node)
        self.fusion_bn0 = MaskedBatchNorm(2 * dim_node)
        self.fusion_drop = Dropout(0.5)
        self.fusion_fc1 = nn.Linear(2 * dim_node, dim_node)
        self.fusion_bn1 = MaskedBatchNorm(dim_node)

    def forward(self, f3d, f2d, e, edge_index, obj_mask, edge_mask, obj_center, rng=None):
        mask, bias = self._mask_and_bias(obj_mask, obj_center)
        att = lambda name, q, kv: getattr(self, name)(q, kv, kv, mask=mask, bias=bias,
                                                      rng=rng)
        f3d_sa = att("self_attn_3d", f3d, f3d)
        f2d_sa = att("self_attn_2d", f2d, f2d)
        f3d_ca = att("cross_attn_3d", f3d_sa, f2d_sa)
        f2d_ca = att("cross_attn_2d", f2d_sa, f3d_sa)
        h = torch.relu(self.fusion_fc0(torch.cat([f3d_sa, f2d_sa, f3d_ca, f2d_ca], dim=-1)))
        h = self.fusion_drop(self.fusion_bn0(h, obj_mask), rng)
        obj = self.fusion_bn1(torch.relu(self.fusion_fc1(h)), obj_mask)
        mimic = obj.detach()
        obj, e = self.gcns(obj, e, edge_index, edge_mask, rng)
        return obj, e, mimic


class MMGStudentCore(_Core):
    """Self-attention before (the mimic tap) and after, then the GCN stack
    (mmteacher.py:128-159)."""

    def __init__(self, dim_node: int = 512, dim_edge: int = 512, dim_atten: int = 256,
                 num_heads: int = 8, depth: int = 2, aggr: str = "max",
                 dropout_atten: float = 0.5, use_edge: bool = True):
        super().__init__(dim_node, dim_edge, dim_atten, num_heads, depth, aggr,
                         dropout_atten, use_edge)
        self.self_attn_before = MultiHeadAttention(num_heads, dim_node)
        self.self_attn_after = MultiHeadAttention(num_heads, dim_node)

    def forward(self, f, e, edge_index, obj_mask, edge_mask, obj_center, rng=None):
        mask, bias = self._mask_and_bias(obj_mask, obj_center)
        f = self.self_attn_before(f, f, f, mask=mask, bias=bias, rng=rng)
        mimic = f
        f = self.self_attn_after(f, f, f, mask=mask, bias=bias, rng=rng)
        f, e = self.gcns(f, e, edge_index, edge_mask, rng)
        return f, e, mimic


class MMTeacher(nn.Module):
    """The teacher/student model (mmteacher.py:162-227).  It reads the
    dimensions, ``use_spatial``, ``clip_feat_dim`` and ``adapter_alpha`` of
    ``MMGNetConfig``; ``obj_text_features`` seeds both cosine classifiers."""

    def __init__(self, cfg: MMGNetConfig = MMGNetConfig(),
                 obj_text_features: Optional[np.ndarray] = None):
        super().__init__()
        self.cfg = cfg
        self.obj_text_features = obj_text_features
        self.text_classifiers = ("obj_predictor_teacher", "obj_predictor_student")
        d = cfg.dim_node
        self.obj_encoder_teacher = PointNetEncoder(cfg.point_channels, d - 8)
        self.obj_encoder_student = PointNetEncoder(cfg.point_channels,
                                                   cfg.point_feature_size)
        self.mlp_student_fc = nn.Linear(cfg.point_feature_size, d - 8)
        self.mlp_student_bn = MaskedBatchNorm(d - 8)
        self.mlp_student_drop = Dropout(0.1)
        self.rel_encoder_teacher = PointNetEncoder(11, d)
        self.rel_encoder_student = PointNetEncoder(11, d)
        self.clip_adapter = AdapterModel(cfg.clip_feat_dim, alpha=cfg.adapter_alpha)
        core_kw = dict(dim_node=d, dim_edge=d, dim_atten=cfg.dim_atten,
                       num_heads=cfg.num_heads, depth=cfg.depth, aggr=cfg.gcn_aggr,
                       dropout_atten=cfg.dropout_atten, use_edge=cfg.use_gcn_edge)
        self.mmg_teacher = MMGTeacherCore(**core_kw)
        self.mmg_student = MMGStudentCore(**core_kw)
        for tower in ("teacher", "student"):
            self.add_module(f"rel_predictor_{tower}", RelPredictor(
                d, cfg.num_rel_classes, multi_label=cfg.multi_rel_outputs))
            self.register_parameter(f"obj_{tower}_logit_scale",
                                    nn.Parameter(torch.tensor(math.log(1 / 0.07))))
            self.add_module(f"obj_predictor_{tower}", nn.Linear(d, cfg.num_obj_classes))
            self.add_module(f"triplet_projector_{tower}", TripletProjector(3 * d))
        set_layer_norm_eps(self, cfg.ln_eps)

    def forward(self, batch: SceneBatch, istrain: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        f_t = self.obj_encoder_teacher(batch.obj_points)
        f_s = self.obj_encoder_student(batch.obj_points)
        f_s_mimic_before = f_s[..., :512]
        f_s = self.mlp_student_fc(f_s)
        f_s = self.mlp_student_drop(torch.relu(self.mlp_student_bn(f_s, batch.obj_mask)),
                                    rng)
        if self.cfg.use_spatial:
            spatial = spatial_features(batch.descriptor)
            f_t = torch.cat([f_t, spatial], dim=-1)
            f_s = torch.cat([f_s, spatial], dim=-1)
        ed = edge_descriptor(batch.descriptor, batch.edge_index).detach()[..., None, :]
        e_t = self.rel_encoder_teacher(ed)
        e_s = self.rel_encoder_student(ed)
        obj_2d = self.clip_adapter(batch.obj_2d_feats).detach()

        center = batch.descriptor[..., :3]
        g_t, ge_t, mimic_t = self.mmg_teacher(f_t, obj_2d, e_t, batch.edge_index,
                                              batch.obj_mask, batch.edge_mask, center, rng)
        g_s, ge_s, mimic_s = self.mmg_student(f_s, e_s, batch.edge_index, batch.obj_mask,
                                              batch.edge_mask, center, rng)
        rel_t = self.rel_predictor_teacher(ge_t, rng)
        rel_s = self.rel_predictor_student(ge_s, rng)
        scale_t = torch.exp(self.obj_teacher_logit_scale)
        scale_s = torch.exp(self.obj_student_logit_scale)
        obj_t = scale_t * self.obj_predictor_teacher(safe_normalize(g_t))
        obj_s = scale_s * self.obj_predictor_student(safe_normalize(g_s))
        out = {"obj_logits_3d": obj_s, "rel_cls_3d": rel_s,
               "obj_logits_2d": obj_t, "rel_cls_2d": rel_t}
        if istrain:
            def pair(g, ge, projector):
                gi, gj = gather_edge_endpoints(g, batch.edge_index)
                return projector(torch.cat([gi, gj, ge], dim=-1), rng)

            out.update(
                obj_feature_teacher_mimic=mimic_t,
                obj_feature_student_mimic=mimic_s,
                obj_feature_student_mimic_before=f_s_mimic_before,
                obj_2d_feats_mimic=obj_2d,
                edge_feature_teacher_dis=pair(g_t, ge_t, self.triplet_projector_teacher),
                edge_feature_student_dis=pair(g_s, ge_s, self.triplet_projector_student),
                logit_scale=scale_s)
        return out


def mmteacher_loss(outputs: Dict[str, torch.Tensor], batch: SceneBatch,
                   lambda_o: float = 0.1) -> Tuple[torch.Tensor, Aux]:
    """lambda_o * (obj_s + obj_t) + 3 * (rel_s + rel_t)
    + 0.1 * (mimic_before + mimic_after + rel_mimic_t + rel_mimic_s), the
    lambdas normalised by their max (mmteacher.py:230-253)."""
    lambda_r, lambda_o = _normalised_lambdas(lambda_o)
    obj_s = cross_entropy(outputs["obj_logits_3d"], batch.gt_class, batch.obj_mask)
    obj_t = cross_entropy(outputs["obj_logits_2d"], batch.gt_class, batch.obj_mask)
    w = dynamic_rel_weights(batch.gt_rels, batch.edge_mask)
    rel_s = weighted_bce(outputs["rel_cls_3d"], batch.gt_rels, w, batch.edge_mask)
    rel_t = weighted_bce(outputs["rel_cls_2d"], batch.gt_rels, w, batch.edge_mask)
    mimic_before = cosine_mimic_loss(outputs["obj_feature_student_mimic_before"],
                                     outputs["obj_2d_feats_mimic"], batch.obj_mask)
    mimic_after = cosine_mimic_loss(outputs["obj_feature_student_mimic"],
                                    outputs["obj_feature_teacher_mimic"], batch.obj_mask)
    if batch.rel_text_feat is not None:
        rm_t = rel_mimic_l1(outputs["edge_feature_teacher_dis"], batch.rel_text_feat,
                            batch.edge_mask)
        rm_s = rel_mimic_l1(outputs["edge_feature_student_dis"], batch.rel_text_feat,
                            batch.edge_mask)
    else:
        rm_t = rm_s = obj_s.new_zeros(())
    total = (lambda_o * (obj_s + obj_t) + 3.0 * lambda_r * (rel_s + rel_t)
             + 0.1 * (mimic_before + mimic_after + rm_t + rm_s))
    return total, dict(loss=total, obj_loss=obj_s, obj_loss_teacher=obj_t,
                       rel_loss=rel_s, rel_loss_teacher=rel_t,
                       mimic_before=mimic_before, mimic_after=mimic_after,
                       rel_mimic_teacher=rm_t, rel_mimic_student=rm_s)
