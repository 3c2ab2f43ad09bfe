"""PyTorch oracle of the original reference's forward passes (PyG-free):
the benchmark's frozen copy of the layer code that certifies the port.

A torch re-implementation of the reference ``Mmgnet`` eval/train forward
(src/model/SGFN_MMG/model.py:288-335 + network_MMG.py:44-250) and of the
baselines: its child-module names and Sequential indices replicate the
reference state-dict layout exactly, so a checkpoint importer can consume
``module_state_dicts`` of a randomly initialised oracle and the two
implementations can be run on identical weights + inputs (the
same-input -> allclose idiom of the reference's own op_utils.py:283-303
checks).

torch-geometric is not needed, so the gather/scatter plumbing uses
``index_select`` / ``scatter_reduce`` with the reference's
``target_to_source`` flow: x_i = subject = edge_index[:, 0], messages
aggregate onto the subject.

Everything runs in module eval() mode (dropout off, BN running stats); the
``istrain`` flag only toggles the extra mimic outputs, mirroring the
reference's forward signature.  The module imports torch and numpy only.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class _PointNetfeat(nn.Module):
    """conv1/conv2/conv3 (k=1) + ReLU each + max-pool over points.

    Reference network_PointNet.py:120-165 with batch_norm=False (the
    shipped config; the reference's BN calls discard their output anyway).
    """

    def __init__(self, point_size: int, out_size: int):
        super().__init__()
        self.conv1 = nn.Conv1d(point_size, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, out_size, 1)

    def forward(self, x):  # (n, C, P)
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        return x.max(dim=2).values


class _SDPAttention(nn.Module):
    """ScaledDotProductAttention (transformer/attention.py:6-78)."""

    def __init__(self, d_model: int, h: int):
        super().__init__()
        self.h, self.dk = h, d_model // h
        self.fc_q = nn.Linear(d_model, d_model)
        self.fc_k = nn.Linear(d_model, d_model)
        self.fc_v = nn.Linear(d_model, d_model)
        self.fc_o = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, bias=None, mask=None):
        b, nq, _ = q.shape
        nk = k.shape[1]
        qh = self.fc_q(q).view(b, nq, self.h, self.dk).permute(0, 2, 1, 3)
        kh = self.fc_k(k).view(b, nk, self.h, self.dk).permute(0, 2, 3, 1)
        vh = self.fc_v(v).view(b, nk, self.h, self.dk).permute(0, 2, 1, 3)
        att = qh @ kh / math.sqrt(self.dk)
        if bias is not None:  # way='add' (the distance-bias path)
            att = att + bias
        if mask is not None:
            att = att.masked_fill(mask == 0, float("-inf"))
        att = att.softmax(-1)
        out = (att @ vh).permute(0, 2, 1, 3).reshape(b, nq, self.h * self.dk)
        return self.fc_o(out)


class _MHA(nn.Module):
    """Post-norm residual wrapper (attention.py:81-126, eval: dropout off)."""

    def __init__(self, d_model: int, h: int):
        super().__init__()
        self.attention = _SDPAttention(d_model, h)
        self.layer_norm = nn.LayerNorm(d_model)

    def forward(self, q, k, v, bias=None, mask=None):
        return self.layer_norm(q + self.attention(q, k, v, bias, mask))


class _EdgeAtten(nn.Module):
    """MultiHeadedEdgeAttention (network_MMG.py:44-112), 'fat' attention."""

    def __init__(self, dim_node=512, dim_edge=512, dim_atten=256, heads=8):
        super().__init__()
        self.h = heads
        self.d_n, self.d_e, self.d_o = dim_node // heads, dim_edge // heads, dim_atten // heads
        hid = dim_node + dim_edge
        self.nn_edge = nn.Sequential(
            nn.Linear(2 * dim_node + dim_edge, hid), nn.ReLU(), nn.Linear(hid, dim_edge))
        # MLP([d_n+d_e, d_n+d_e, d_o], drop_out=0.5): Conv0, ReLU, Dropout, Conv3
        dh = self.d_n + self.d_e
        self.nn = nn.Sequential(
            nn.Conv1d(dh, dh, 1), nn.ReLU(), nn.Dropout(0.5), nn.Conv1d(dh, self.d_o, 1))
        self.proj_edge = nn.Sequential(nn.Linear(dim_edge, dim_edge))
        self.proj_query = nn.Sequential(nn.Linear(dim_node, dim_node))
        self.proj_value = nn.Sequential(nn.Linear(dim_node, dim_atten))

    def forward(self, x_i, e, x_j):
        e_new = self.nn_edge(torch.cat([x_i, e, x_j], dim=1))
        v = self.proj_value(x_j)
        q = self.proj_query(x_i).view(-1, self.d_n, self.h)
        ep = self.proj_edge(e).view(-1, self.d_e, self.h)
        prob = self.nn(torch.cat([q, ep], dim=1)).softmax(1)  # (E, d_o, H)
        return prob.reshape_as(v) * v, e_new


class _GraphEdgeAttenNetwork(nn.Module):
    """edgeatten + prop, scatter-max onto the subject (network_MMG.py:12-41)."""

    def __init__(self, dim_node=512, dim_edge=512, dim_atten=256, heads=8):
        super().__init__()
        self.edgeatten = _EdgeAtten(dim_node, dim_edge, dim_atten, heads)
        hid = dim_node + dim_atten
        self.prop = nn.Sequential(nn.Linear(hid, hid), nn.ReLU(), nn.Linear(hid, dim_node))
        self.dim_atten = dim_atten

    def forward(self, x, e, ei):  # ei: (E, 2) int64, subject at [:, 0]
        x_i = x.index_select(0, ei[:, 0])
        x_j = x.index_select(0, ei[:, 1])
        msg, e_new = self.edgeatten(x_i, e, x_j)
        # torch-scatter 'max' semantics: empty segments -> 0, true negative
        # maxima preserved (include_self=False ignores the zero init)
        agg = x.new_zeros(x.shape[0], self.dim_atten).scatter_reduce(
            0, ei[:, 0:1].expand(-1, self.dim_atten), msg, reduce="amax",
            include_self=False)
        return self.prop(torch.cat([x, agg], dim=1)), e_new


class _MMG(nn.Module):
    """Dual-branch stack (network_MMG.py:115-250) with the reference's
    per-scene block-diagonal mask / distance-bias Python loop."""

    def __init__(self, depth=2, heads=8, dim_node=512, dim_edge=512, dim_atten=256):
        super().__init__()
        self.depth, self.h = depth, heads
        self.self_attn = nn.ModuleList(_MHA(dim_node, heads) for _ in range(depth))
        self.cross_attn = nn.ModuleList(_MHA(dim_node, heads) for _ in range(depth))
        self.cross_attn_rel = nn.ModuleList(_MHA(dim_edge, heads) for _ in range(depth))
        self.gcn_3ds = nn.ModuleList(
            _GraphEdgeAttenNetwork(dim_node, dim_edge, dim_atten, heads) for _ in range(depth))
        self.gcn_2ds = nn.ModuleList(
            _GraphEdgeAttenNetwork(dim_node, dim_edge, dim_atten, heads) for _ in range(depth))
        self.self_attn_fc = nn.Sequential(
            nn.Linear(4, 32), nn.ReLU(), nn.LayerNorm(32),
            nn.Linear(32, 32), nn.ReLU(), nn.LayerNorm(32), nn.Linear(32, heads))

    def forward(self, f3d, f2d, e3d, e2d, ei, batch_ids, centers):
        n = f3d.shape[0]
        mask = torch.zeros(1, 1, n, n)
        bias = torch.zeros(1, self.h, n, n)
        count = 0
        for b in range(int(batch_ids.max().item()) + 1):
            idx = torch.where(batch_ids == b)[0]
            k = len(idx)
            mask[:, :, count:count + k, count:count + k] = 1
            ca = centers[None, idx, :].expand(k, k, 3)  # key along axis 1
            cb = centers[idx, None, :].expand(k, k, 3)  # query along axis 0
            delta = ca - cb
            dist = delta.pow(2).sum(-1, keepdim=True).sqrt()
            w = self.self_attn_fc(torch.cat([delta, dist], -1).unsqueeze(0))
            bias[:, :, count:count + k, count:count + k] = w.permute(0, 3, 1, 2)
            count += k

        f3d, f2d = f3d.unsqueeze(0), f2d.unsqueeze(0)
        for i in range(self.depth):
            f3d = self.self_attn[i](f3d, f3d, f3d, bias, mask)
            f2d = self.cross_attn[i](f2d, f3d, f3d, bias, mask)
            a3, e3d = self.gcn_3ds[i](f3d[0], e3d, ei)
            a2, e2d = self.gcn_2ds[i](f2d[0], e2d, ei)
            # reference attaches NO mask here (network_MMG.py:231)
            e2d = self.cross_attn_rel[i](
                e2d.unsqueeze(0), e3d.unsqueeze(0), e3d.unsqueeze(0))[0]
            f3d, f2d = a3.unsqueeze(0), a2.unsqueeze(0)
            if i < self.depth - 1 or self.depth == 1:
                f3d, f2d = F.relu(f3d), F.relu(f2d)
                e3d, e2d = F.relu(e3d), F.relu(e2d)
        return f3d[0], f2d[0], e3d, e2d


class _RelPredictorMulti(nn.Module):
    """PointNetRelClsMulti / PointNetRelCls, batch_norm=False
    (network_PointNet.py:305-341 / :250-301): identical trunk, sigmoid for
    the multi-label head, log_softmax for the single-label one."""

    def __init__(self, k: int, in_size: int = 512, multi_label: bool = True):
        super().__init__()
        self.multi_label = multi_label
        self.fc1 = nn.Linear(in_size, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)

    def forward(self, x):
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))  # dropout sits before this ReLU; eval -> off
        x = self.fc3(x)
        return torch.sigmoid(x) if self.multi_label else F.log_softmax(x, dim=-1)


class _Adapter(nn.Module):
    """clip_adapter/model.py:6-33 residual adapter."""

    def __init__(self, dim=512, alpha=0.5):
        super().__init__()
        self.alpha = alpha
        self.fc1 = nn.Linear(dim, 256)
        self.fc2 = nn.Linear(256, dim)

    def forward(self, x):
        return self.alpha * self.fc2(F.relu(self.fc1(x))) + (1 - self.alpha) * x


class TorchMmgnetOracle(nn.Module):
    """Reference ``Mmgnet`` forward twin; run in eval() mode."""

    def __init__(self, num_obj=160, num_rel=26, depth=2, heads=8,
                 multi_rel=True):
        super().__init__()
        self.obj_encoder = _PointNetfeat(3, 768)
        self.rel_encoder_2d = _PointNetfeat(11, 512)
        self.rel_encoder_3d = _PointNetfeat(11, 512)
        self.mmg = _MMG(depth=depth, heads=heads)
        self.clip_adapter = _Adapter()
        self.rel_predictor_3d = _RelPredictorMulti(num_rel, multi_label=multi_rel)
        self.rel_predictor_2d = _RelPredictorMulti(num_rel, multi_label=multi_rel)
        self.obj_predictor_3d = nn.Linear(512, num_obj)
        self.obj_predictor_2d = nn.Linear(512, num_obj)
        self.mlp_3d = nn.Sequential(
            nn.Linear(768, 504), nn.BatchNorm1d(504), nn.ReLU(), nn.Dropout(0.1))
        self.triplet_projector_2d = nn.Sequential(
            nn.Linear(512 * 3, 1024), nn.Dropout(0.5), nn.ReLU(), nn.Linear(1024, 512))
        self.obj_logit_scale = nn.Parameter(
            torch.tensor(float(np.log(1 / 0.07)), dtype=torch.float32))

    # NOTE: no @torch.no_grad() — gradient-parity tests differentiate these
    # twins; inference callers wrap calls in torch.no_grad() themselves.
    def forward(self, obj_points, obj_2d_feats, edge_index, descriptor,
                batch_ids, istrain=False):
        """obj_points (n, P, 3); obj_2d_feats (n, 512); edge_index (E, 2)
        with subject at [:, 0]; descriptor (n, 11); batch_ids (n,)."""
        ei = edge_index.long()
        f = self.obj_encoder(obj_points.transpose(1, 2))
        mimic_3d = f[..., :512].clone()
        f = self.mlp_3d(f)
        spatial = descriptor[:, 3:].clone()
        spatial[:, 6:] = spatial[:, 6:].log()
        f3d = torch.cat([f, spatial], dim=-1)

        d_i = descriptor.index_select(0, ei[:, 0])
        d_j = descriptor.index_select(0, ei[:, 1])
        ed = torch.cat(
            [d_i[:, :6] - d_j[:, :6], (d_i[:, 6:] / d_j[:, 6:]).log()], dim=-1)
        rel_2d = self.rel_encoder_2d(ed.unsqueeze(-1))
        rel_3d = self.rel_encoder_3d(ed.unsqueeze(-1))

        f2d = self.clip_adapter(obj_2d_feats)
        mimic_2d = f2d.clone()

        centers = descriptor[:, :3]
        f3d, f2d, e3d, e2d = self.mmg(f3d, f2d, rel_3d, rel_2d, ei, batch_ids, centers)

        rel_cls_3d = self.rel_predictor_3d(e3d)
        rel_cls_2d = self.rel_predictor_2d(e2d)
        scale = self.obj_logit_scale.exp()
        o3 = scale * self.obj_predictor_3d(f3d / f3d.norm(dim=-1, keepdim=True))
        o2 = scale * self.obj_predictor_2d(f2d / f2d.norm(dim=-1, keepdim=True))
        out = dict(obj_logits_3d=o3, obj_logits_2d=o2,
                   rel_cls_3d=rel_cls_3d, rel_cls_2d=rel_cls_2d)
        if istrain:
            pair = torch.cat(
                [f2d.index_select(0, ei[:, 0]), f2d.index_select(0, ei[:, 1]), e2d],
                dim=-1)
            out.update(
                obj_feature_3d_mimic=mimic_3d,
                obj_features_2d_mimic=mimic_2d,
                edge_feature_2d_dis=self.triplet_projector_2d(pair),
                logit_scale=scale,
            )
        return out


class _MMGSingle(nn.Module):
    """3D-only stack (reference ``MMG_single``, network_MMG.py:253-295)."""

    def __init__(self, depth=2, heads=8):
        super().__init__()
        self.depth = depth
        self.gcn_3ds = nn.ModuleList(
            _GraphEdgeAttenNetwork(heads=heads) for _ in range(depth))

    def forward(self, f3d, e3d, ei):
        for i in range(self.depth):
            f3d, e3d = self.gcn_3ds[i](f3d, e3d, ei)
            if i < self.depth - 1 or self.depth == 1:
                f3d, e3d = F.relu(f3d), F.relu(e3d)
        return f3d, e3d


class TorchMmgnetSingleOracle(nn.Module):
    """Reference ``model_single.Mmgnet`` forward twin (model_single.py:247-284)."""

    def __init__(self, num_obj=160, num_rel=26, depth=2, heads=8):
        super().__init__()
        self.obj_encoder = _PointNetfeat(3, 768)
        self.rel_encoder_3d = _PointNetfeat(11, 512)
        self.mmg = _MMGSingle(depth=depth, heads=heads)
        self.mlp_3d = nn.Sequential(
            nn.Linear(768, 504), nn.BatchNorm1d(504), nn.ReLU(), nn.Dropout(0.1))
        self.rel_predictor_3d = _RelPredictorMulti(num_rel)
        self.obj_predictor_3d = nn.Linear(512, num_obj)
        self.triplet_projector_3d = nn.Sequential(
            nn.Linear(512 * 3, 1024), nn.Dropout(0.5), nn.ReLU(), nn.Linear(1024, 512))
        self.obj_logit_scale = nn.Parameter(
            torch.tensor(float(np.log(1 / 0.07)), dtype=torch.float32))

    # NOTE: no @torch.no_grad() — gradient-parity tests differentiate these
    # twins; inference callers wrap calls in torch.no_grad() themselves.
    def forward(self, obj_points, edge_index, descriptor, istrain=False):
        ei = edge_index.long()
        f = self.obj_encoder(obj_points.transpose(1, 2))
        f = self.mlp_3d(f)
        spatial = descriptor[:, 3:].clone()
        spatial[:, 6:] = spatial[:, 6:].log()
        f3d = torch.cat([f, spatial], dim=-1)
        d_i = descriptor.index_select(0, ei[:, 0])
        d_j = descriptor.index_select(0, ei[:, 1])
        ed = torch.cat(
            [d_i[:, :6] - d_j[:, :6], (d_i[:, 6:] / d_j[:, 6:]).log()], dim=-1)
        e3d = self.rel_encoder_3d(ed.unsqueeze(-1))
        f3d, e3d = self.mmg(f3d, e3d, ei)
        rel_cls = self.rel_predictor_3d(e3d)
        scale = self.obj_logit_scale.exp()
        o3 = scale * self.obj_predictor_3d(f3d / f3d.norm(dim=-1, keepdim=True))
        out = dict(obj_logits_3d=o3, rel_cls_3d=rel_cls)
        if istrain:
            pair = torch.cat(
                [f3d.index_select(0, ei[:, 0]), f3d.index_select(0, ei[:, 1]), e3d],
                dim=-1)
            out.update(edge_feature_3d_dis=self.triplet_projector_3d(pair),
                       logit_scale=scale)
        return out


class _ObjClsHead(nn.Module):
    """PointNetCls, batch_norm=False (network_PointNet.py:197-248)."""

    def __init__(self, k: int, in_size: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(in_size, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)

    def forward(self, x):
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))  # dropout before the ReLU; eval -> off
        return F.log_softmax(self.fc3(x), dim=-1)


class _GraphEdgeAttenNetworkLayers(nn.Module):
    """SGFN GNN (network_GNN.py:197-284): distance-biased self-attention
    (8 heads fixed in the reference) + fat-gated GCN per layer."""

    def __init__(self, num_layers=2, heads=8, dim_node=512, dim_edge=256,
                 dim_atten=256):
        super().__init__()
        self.num_layers = num_layers
        self.self_attn = nn.ModuleList(_MHA(dim_node, 8) for _ in range(num_layers))
        self.self_attn_fc = nn.Sequential(
            nn.Linear(4, 32), nn.ReLU(), nn.LayerNorm(32),
            nn.Linear(32, 32), nn.ReLU(), nn.LayerNorm(32), nn.Linear(32, 8))
        self.gconvs = nn.ModuleList(
            _GraphEdgeAttenNetwork(dim_node, dim_edge, dim_atten, heads)
            for _ in range(num_layers))

    def forward(self, x, e, ei, centers, batch_ids):
        n = x.shape[0]
        mask = torch.zeros(1, 1, n, n)
        bias = torch.zeros(1, 8, n, n)
        count = 0
        for b in range(int(batch_ids.max().item()) + 1):
            idx = torch.where(batch_ids == b)[0]
            k = len(idx)
            mask[:, :, count:count + k, count:count + k] = 1
            delta = centers[None, idx, :].expand(k, k, 3) - centers[idx, None, :].expand(k, k, 3)
            dist = delta.pow(2).sum(-1, keepdim=True).sqrt()
            w = self.self_attn_fc(torch.cat([delta, dist], -1).unsqueeze(0))
            bias[:, :, count:count + k, count:count + k] = w.permute(0, 3, 1, 2)
            count += k
        for i in range(self.num_layers):
            x = self.self_attn[i](x.unsqueeze(0), x.unsqueeze(0), x.unsqueeze(0),
                                  bias, mask)[0]
            x, e = self.gconvs[i](x, e, ei)
            if i < self.num_layers - 1 or self.num_layers == 1:
                x, e = F.relu(x), F.relu(e)
        return x, e


class TorchSGFNOracle(nn.Module):
    """Reference ``baseline_sgfn.SGFN`` forward twin (baseline_sgfn.py:101-123)."""

    def __init__(self, num_obj=160, num_rel=26, depth=2, heads=8, dim_edge=256):
        super().__init__()
        self.obj_encoder = _PointNetfeat(3, 504)
        self.rel_encoder = _PointNetfeat(11, dim_edge)
        self.gcn = _GraphEdgeAttenNetworkLayers(depth, heads, 512, dim_edge, 256)
        self.obj_predictor = _ObjClsHead(num_obj)
        self.rel_predictor = _RelPredictorMulti(num_rel, in_size=dim_edge)

    # NOTE: no @torch.no_grad() — gradient-parity tests differentiate these
    # twins; inference callers wrap calls in torch.no_grad() themselves.
    def forward(self, obj_points, edge_index, descriptor, batch_ids):
        ei = edge_index.long()
        f = self.obj_encoder(obj_points.transpose(1, 2))
        spatial = descriptor[:, 3:].clone()
        spatial[:, 6:] = spatial[:, 6:].log()
        f = torch.cat([f, spatial], dim=1)
        d_i = descriptor.index_select(0, ei[:, 0])
        d_j = descriptor.index_select(0, ei[:, 1])
        ed = torch.cat(
            [d_i[:, :6] - d_j[:, :6], (d_i[:, 6:] / d_j[:, 6:]).log()], dim=-1)
        e = self.rel_encoder(ed.unsqueeze(-1))
        f, e = self.gcn(f, e, ei, descriptor[:, :3], batch_ids)
        return dict(obj_logits_3d=self.obj_predictor(f),
                    rel_cls_3d=self.rel_predictor(e))


class _TripletGCN(nn.Module):
    """Reference ``TripletGCN`` (network_TripletGCN.py:43-71), PyG-free.

    flow is PyG's default source_to_target: x_i is the TARGET
    (edge_index[:, 1]), x_j the source, and messages aggregate (sum) onto
    the target.  nn1 has BN+ReLU after every layer (on_last=True), nn2
    between layers only; run in eval() mode (BN running stats)."""

    def __init__(self, dim_node=32, dim_edge=16, dim_hidden=64):
        super().__init__()
        self.dh, self.de = dim_hidden, dim_edge
        self.nn1 = nn.Sequential(
            nn.Linear(2 * dim_node + dim_edge, dim_hidden),
            nn.BatchNorm1d(dim_hidden), nn.ReLU(),
            nn.Linear(dim_hidden, 2 * dim_hidden + dim_edge),
            nn.BatchNorm1d(2 * dim_hidden + dim_edge), nn.ReLU())
        self.nn2 = nn.Sequential(
            nn.Linear(dim_hidden, dim_hidden), nn.BatchNorm1d(dim_hidden),
            nn.ReLU(), nn.Linear(dim_hidden, dim_node))

    def forward(self, x, e, ei):
        x_i = x.index_select(0, ei[:, 1])
        x_j = x.index_select(0, ei[:, 0])
        m = self.nn1(torch.cat([x_i, e, x_j], dim=1))
        new_i = m[:, :self.dh]
        new_e = m[:, self.dh:self.dh + self.de]
        new_j = m[:, self.dh + self.de:]
        msg = new_i + new_j
        agg = torch.zeros(x.shape[0], self.dh).index_add_(0, ei[:, 1], msg)
        return x + self.nn2(agg), new_e


def _distance_bias(self_attn_fc, centers, heads):
    """Single-scene distance bias (network_MMG.py:357-381 loop body)."""
    k = centers.shape[0]
    delta = centers[None, :, :].expand(k, k, 3) - centers[:, None, :].expand(k, k, 3)
    dist = delta.pow(2).sum(-1, keepdim=True).sqrt()
    w = self_attn_fc(torch.cat([delta, dist], -1).unsqueeze(0))
    return w.permute(0, 3, 1, 2)  # (1, H, N, N)


def _dist_mlp(heads=8):
    return nn.Sequential(
        nn.Linear(4, 32), nn.ReLU(), nn.LayerNorm(32),
        nn.Linear(32, 32), nn.ReLU(), nn.LayerNorm(32), nn.Linear(32, heads))


class _MMGTeacherCore(nn.Module):
    """MMG_teacher twin (network_MMG.py:298-416): 4-way attention + fusion
    MLP (Linear-ReLU-BN-Dropout-Linear-ReLU-BN) + GCN stack; eval mode."""

    def __init__(self, dim=512, heads=8, depth=2):
        super().__init__()
        self.heads, self.depth = heads, depth
        self.self_attn_3d = _MHA(dim, heads)
        self.self_attn_2d = _MHA(dim, heads)
        self.cross_attn_3d = _MHA(dim, heads)
        self.cross_attn_2d = _MHA(dim, heads)
        self.fusion_module = nn.Sequential(
            nn.Linear(dim * 4, dim * 2), nn.ReLU(), nn.BatchNorm1d(dim * 2),
            nn.Dropout(0.5), nn.Linear(dim * 2, dim), nn.ReLU(),
            nn.BatchNorm1d(dim))
        self.gcns = nn.ModuleList(
            _GraphEdgeAttenNetwork(heads=heads) for _ in range(depth))
        self.self_attn_fc = _dist_mlp(heads)

    # NOTE: no @torch.no_grad() — gradient-parity tests differentiate these
    # twins; inference callers wrap calls in torch.no_grad() themselves.
    def forward(self, f3d, f2d, e, ei, centers):  # single scene, (N, D)
        n = f3d.shape[0]
        mask = torch.ones(1, 1, n, n)
        bias = _distance_bias(self.self_attn_fc, centers, self.heads)
        f3 = self.self_attn_3d(f3d.unsqueeze(0), f3d.unsqueeze(0),
                               f3d.unsqueeze(0), bias, mask)
        f2 = self.self_attn_2d(f2d.unsqueeze(0), f2d.unsqueeze(0),
                               f2d.unsqueeze(0), bias, mask)
        c3 = self.cross_attn_3d(f3, f2, f2, bias, mask)
        c2 = self.cross_attn_2d(f2, f3, f3, bias, mask)
        fused = torch.cat([f3[0], f2[0], c3[0], c2[0]], dim=-1)
        obj = self.fusion_module(fused)
        mimic = obj.clone()
        for i in range(self.depth):
            obj, e = self.gcns[i](obj, e, ei)
            if i < self.depth - 1 or self.depth == 1:
                obj, e = F.relu(obj), F.relu(e)
        return obj, e, mimic


class _MMGStudentCore(nn.Module):
    """MMG_student twin (network_MMG.py:419-529): self-attn before (mimic
    tap) and after, then the GCN stack; eval mode."""

    def __init__(self, dim=512, heads=8, depth=2):
        super().__init__()
        self.heads, self.depth = heads, depth
        self.self_attn_before = _MHA(dim, heads)
        self.self_attn_after = _MHA(dim, heads)
        self.gcns = nn.ModuleList(
            _GraphEdgeAttenNetwork(heads=heads) for _ in range(depth))
        self.self_attn_fc = _dist_mlp(heads)

    # NOTE: no @torch.no_grad() — gradient-parity tests differentiate these
    # twins; inference callers wrap calls in torch.no_grad() themselves.
    def forward(self, f, e, ei, centers):
        n = f.shape[0]
        mask = torch.ones(1, 1, n, n)
        bias = _distance_bias(self.self_attn_fc, centers, self.heads)
        f = self.self_attn_before(f.unsqueeze(0), f.unsqueeze(0),
                                  f.unsqueeze(0), bias, mask)
        mimic = f[0].clone()
        f = self.self_attn_after(f, f, f, bias, mask)[0]
        for i in range(self.depth):
            f, e = self.gcns[i](f, e, ei)
            if i < self.depth - 1 or self.depth == 1:
                f, e = F.relu(f), F.relu(e)
        return f, e, mimic


def _dgcnn_graph_feature(x, k):
    """Reference knn + get_graph_feature (SGGpoint/model.py:62-95), minus
    the hard-coded .cuda(): x (M, C, P) -> (M, 2C, P, k)."""
    inner = -2 * torch.matmul(x.transpose(2, 1), x)
    xx = torch.sum(x ** 2, dim=1, keepdim=True)
    idx = (-xx - inner - xx.transpose(2, 1)).topk(k=k, dim=-1)[1]
    m, c, p = x.shape
    base = torch.arange(m).view(-1, 1, 1) * p
    flat = (idx + base).view(-1)
    xt = x.transpose(2, 1).contiguous()
    feat = xt.reshape(m * p, -1)[flat].view(m, p, k, c)
    ctr = xt.view(m, p, 1, c).expand(-1, -1, k, -1)
    return torch.cat((feat - ctr, ctr), dim=3).permute(0, 3, 1, 2).contiguous()


class _DGCNN(nn.Module):
    """Official DGCNN backbone twin (SGGpoint/model.py:97-127); eval mode."""

    def __init__(self, input_channel=3, embeddings=512, k=20):
        super().__init__()
        self.k = k
        mk = lambda cin, cout, conv: nn.Sequential(
            conv(cin, cout, kernel_size=1, bias=False),
            (nn.BatchNorm2d if conv is nn.Conv2d else nn.BatchNorm1d)(cout),
            nn.LeakyReLU(negative_slope=0.2))
        self.conv1 = mk(input_channel * 2, 64, nn.Conv2d)
        self.conv2 = mk(64 * 2, 64, nn.Conv2d)
        self.conv3 = mk(64 * 2, 128, nn.Conv2d)
        self.conv4 = mk(128 * 2, 256, nn.Conv2d)
        self.conv5 = mk(512, embeddings, nn.Conv1d)

    def forward(self, x):  # (M, C, P)
        x1 = self.conv1(_dgcnn_graph_feature(x, self.k)).max(dim=-1).values
        x2 = self.conv2(_dgcnn_graph_feature(x1, self.k)).max(dim=-1).values
        x3 = self.conv3(_dgcnn_graph_feature(x2, self.k)).max(dim=-1).values
        x4 = self.conv4(_dgcnn_graph_feature(x3, self.k)).max(dim=-1).values
        return self.conv5(torch.cat((x1, x2, x3, x4), dim=1))  # (M, emb, P)


class _GCNConv(nn.Module):
    """PyG ``GCNConv(add_self_loops=True)`` equivalent: symmetric
    normalization with degrees from the target column + self loops,
    messages source -> target, bias after aggregation."""

    def __init__(self, cin, cout):
        super().__init__()
        self.lin = nn.Linear(cin, cout, bias=True)

    def forward(self, x, ei):  # x (N, C); ei (2, E) rows [source, target]
        n = x.shape[0]
        deg = torch.zeros(n).index_add_(
            0, ei[1], torch.ones(ei.shape[1])) + 1.0
        norm = deg[ei[0]].rsqrt() * deg[ei[1]].rsqrt()
        agg = torch.zeros_like(x).index_add_(0, ei[1], x[ei[0]] * norm[:, None])
        agg = agg + x / deg[:, None]
        return self.lin(agg)


class _EdgeGCN(nn.Module):
    """EdgeGCN twin (SGGpoint/model.py:136-206), PyG/torch-scatter-free;
    eval mode (dropout off)."""

    def __init__(self, dim=512):
        super().__init__()
        mid = dim // 2
        self.node_GConv1 = _GCNConv(dim, mid)
        self.node_GConv2 = _GCNConv(mid, dim)
        self.edge_MLP1 = nn.Linear(dim, mid)
        self.edge_MLP2 = nn.Linear(mid, dim)
        self.edge_attentionND = nn.Linear(dim, mid)
        self.node_attentionND = nn.Linear(dim, mid)
        self.node_indicator_reduction = nn.Linear(dim, mid)

    def forward(self, x, e, ei):  # x (N, D); e (E, D); ei (2, E)
        n = x.shape[0]
        ind = self.edge_attentionND(e)  # (E, mid)
        cnt_row = torch.zeros(n).index_add_(0, ei[0], torch.ones(ei.shape[1]))
        cnt_col = torch.zeros(n).index_add_(0, ei[1], torch.ones(ei.shape[1]))
        row = torch.zeros(n, ind.shape[1]).index_add_(0, ei[0], ind) \
            / cnt_row.clamp(min=1)[:, None]
        col = torch.zeros(n, ind.shape[1]).index_add_(0, ei[1], ind) \
            / cnt_col.clamp(min=1)[:, None]
        gate = torch.sigmoid(row * col)

        h = F.relu(self.node_GConv1(x, ei)) * gate
        x_new = F.relu(self.node_GConv2(h, ei))

        nind = F.relu(self.node_attentionND(x_new))
        pair = torch.cat([nind[ei[0]], nind[ei[1]]], dim=-1)
        node_gate = torch.sigmoid(self.node_indicator_reduction(pair))

        he = F.relu(self.edge_MLP1(e)) * node_gate
        e_new = F.relu(self.edge_MLP2(he))
        return x_new, e_new


def _child_state_dicts(model: nn.Module, names) -> Dict[str, Dict[str, np.ndarray]]:
    return {
        n: {k: v.detach().cpu().numpy() for k, v in getattr(model, n).state_dict().items()}
        for n in names
    }


def single_module_state_dicts(model: TorchMmgnetSingleOracle):
    out = _child_state_dicts(model, [
        "obj_encoder", "rel_encoder_3d", "mmg", "mlp_3d",
        "rel_predictor_3d", "obj_predictor_3d", "triplet_projector_3d"])
    out["obj_logit_scale"] = {
        "obj_logit_scale": model.obj_logit_scale.detach().cpu().numpy()}
    return out


def sgfn_module_state_dicts(model: TorchSGFNOracle):
    return _child_state_dicts(model, [
        "obj_encoder", "rel_encoder", "gcn", "obj_predictor", "rel_predictor"])


def module_state_dicts(model: TorchMmgnetOracle) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-child state dicts in the reference BaseModel.save layout
    (model_base.py:47-73: one .pth per direct child module)."""
    names = [
        "obj_encoder", "rel_encoder_2d", "rel_encoder_3d", "mmg",
        "clip_adapter", "rel_predictor_2d", "rel_predictor_3d",
        "obj_predictor_2d", "obj_predictor_3d", "mlp_3d",
        "triplet_projector_2d",
    ]
    out = {
        n: {k: v.detach().cpu().numpy() for k, v in getattr(model, n).state_dict().items()}
        for n in names
    }
    out["obj_logit_scale"] = {
        "obj_logit_scale": model.obj_logit_scale.detach().cpu().numpy()
    }
    return out
