"""Plain reference of VL-SAT's SGGpoint, the 3D branch that its deployments
serve (Wang et al., CVPR 2023, src/model/SGGpoint/model.py of
wz7in/CVPR2023-VLSAT, after Zhang et al., CVPR 2021).

The module holds every child of the source's model with the source's
layouts, so that ``module_state_dicts`` gives the original checkpoint
layout (one state dict a direct child, as BaseModel.save writes them):

* ``backbone``: the DGCNN, ``conv1``-``conv4`` each ``Sequential(Conv2d 1x1
  without bias, BatchNorm2d, LeakyReLU(0.2))`` over (M, 2C, P, k), ``conv5``
  ``Sequential(Conv1d 1x1 without bias, BatchNorm1d, LeakyReLU(0.2))``;
* ``mlp_3d``, ``edge_mlp_3d``, ``edge_mlp_2d``, ``obj_mlp_*``, ``rel_mlp_*``:
  Linears; ``clip_adapter``: ``fc1``, ``fc2``;
* ``edge_gcn`` (MMEdgeGCN): ``self_attn_fc`` ``Sequential(Linear, ReLU,
  LayerNorm, Linear, ReLU, LayerNorm, Linear)``, ``self_attn`` /
  ``cross_attn`` / ``cross_attn_rel`` (``attention.fc_{q,k,v,o}``,
  ``layer_norm``), ``edgegcn_3d`` / ``edgegcn_2d`` (EdgeGCN: GCNConv
  ``node_GConv1`` / ``node_GConv2`` with ``lin.weight`` and ``bias``,
  ``edge_MLP1`` / ``edge_MLP2`` ``Sequential(Conv1d 1x1, ReLU)``,
  ``edge_attentionND``, ``node_attentionND``, ``node_indicator_reduction``);
* ``obj_logit_scale``, cosine classifiers ``obj_classifier_*`` (Linear
  without bias), ``rel_classifier_*`` (EdgeMLP: ``edge_linear1``,
  ``edge_BnReluDp`` = BatchNorm1d, LeakyReLU(0.2), Dropout,
  ``edge_linear2``), ``triplet_projector_*`` (``Sequential(Linear, Dropout,
  ReLU, Linear)``).

``forward_3d`` is the 3D branch in eval mode over a block of unpadded
scenes (``plain.flatten``).  Its kNN sets can be given, one (M, P, k) index
tensor an EdgeConv stage for the block's M instances, so that the forward
follows the neighbours the program chose; ``knn64`` gives the float64 kNN
of a stage's input, against which the program's sets are held.

Departures from the source, each without effect on the 3D outputs in eval
mode: dropout off and BatchNorm on its running statistics (``eval()``);
no ``.cuda()`` (the source's ``knn`` builds its index base on the card):
every tensor lives on the input's device; torch-geometric's ``GCNConv`` and
torch-scatter's ``scatter_mean`` written out with ``index_add_``; the
attention computed scene by scene instead of under a block-diagonal mask.
``nn.LayerNorm`` keeps torch's epsilon, 1e-5, as in the source.  Imports
torch only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGES = (64, 64, 128, 256)  # the EdgeConv widths
BACKBONE = 768  # the DGCNN's embedding


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """The source's ``knn``: x (M, C, P) -> (M, P, k) indices of the k
    nearest points (itself included), from -|xi|^2 + 2 xi.xj - |xj|^2."""
    inner = -2 * torch.matmul(x.transpose(2, 1), x)
    xx = torch.sum(x ** 2, dim=1, keepdim=True)
    return (-xx - inner - xx.transpose(2, 1)).topk(k=k, dim=-1)[1]


def graph_feature(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The source's ``get_graph_feature`` for given neighbours: x (M, C, P),
    idx (M, P, k) -> (M, 2C, P, k) = [x_j - x_i, x_i]."""
    m, c, p = x.shape
    k = idx.shape[-1]
    base = torch.arange(m, device=x.device).view(-1, 1, 1) * p
    xt = x.transpose(2, 1).contiguous()
    feat = xt.view(m * p, c)[(idx + base).view(-1)].view(m, p, k, c)
    ctr = xt.view(m, p, 1, c).expand(-1, -1, k, -1)
    return torch.cat((feat - ctr, ctr), dim=3).permute(0, 3, 1, 2).contiguous()


def knn64(x: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """The float64 kNN of a stage's input x (M, C, P): ``dist`` (M, P, P)
    squared distances, ``idx`` (M, P, k) the top k, ``kth`` (M, P) the k-th
    smallest distance and ``margin`` (M, P) the (k+1)-th less the k-th."""
    xd = x.double().transpose(1, 2)
    sq = (xd * xd).sum(-1)
    dist = (sq[:, :, None] + sq[:, None, :] - 2 * xd @ xd.transpose(1, 2)).clamp(min=0)
    near = dist.topk(min(k + 1, dist.shape[-1]), dim=-1, largest=False)
    kth = near.values[..., k - 1]
    nxt = near.values[..., k] if near.values.shape[-1] > k else torch.full_like(kth, math.inf)
    return {"dist": dist, "idx": near.indices[..., :k], "kth": kth, "margin": nxt - kth}


class DGCNN(nn.Module):
    def __init__(self, input_channel: int = 3, embeddings: int = BACKBONE, k: int = 20):
        super().__init__()
        self.k = k
        cin = input_channel
        for i, out in enumerate(STAGES, start=1):
            self.add_module(f"conv{i}", nn.Sequential(
                nn.Conv2d(2 * cin, out, kernel_size=1, bias=False), nn.BatchNorm2d(out),
                nn.LeakyReLU(negative_slope=0.2)))
            cin = out
        self.conv5 = nn.Sequential(nn.Conv1d(sum(STAGES), embeddings, kernel_size=1, bias=False),
                                   nn.BatchNorm1d(embeddings), nn.LeakyReLU(negative_slope=0.2))

    def forward(self, x: torch.Tensor, sets: Optional[Sequence[torch.Tensor]] = None,
                record: Optional[List] = None) -> torch.Tensor:
        """x (M, C, P) -> (M, embeddings, P); ``sets`` the neighbours of each
        stage (else its own kNN); ``record`` collects each stage's input
        (M, C, P) and neighbours (M, P, k)."""
        k = min(self.k, x.shape[-1])
        feats = []
        for i in range(len(STAGES)):
            idx = sets[i] if sets is not None else knn(x, k)
            if record is not None:
                record.append((x, idx))
            x = getattr(self, f"conv{i + 1}")(graph_feature(x, idx)).max(dim=-1)[0]
            feats.append(x)
        return self.conv5(torch.cat(feats, dim=1))


class GCNConv(nn.Module):
    """torch-geometric's ``GCNConv`` (add_self_loops, symmetric
    normalisation, degrees counted at the target): ``lin`` without bias,
    then the propagation source -> target, then ``bias``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.lin = nn.Linear(cin, cout, bias=False)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, ei: torch.Tensor) -> torch.Tensor:
        h = self.lin(x)
        deg = torch.ones(x.shape[0], device=x.device, dtype=x.dtype).index_add_(
            0, ei[1], torch.ones(ei.shape[1], device=x.device, dtype=x.dtype))
        norm = (deg[ei[0]] * deg[ei[1]]).rsqrt()
        out = torch.zeros_like(h).index_add_(0, ei[1], h[ei[0]] * norm[:, None])
        return out + h / deg[:, None] + self.bias


def scatter_mean(src: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    total = src.new_zeros(n, src.shape[1]).index_add_(0, index, src)
    count = src.new_zeros(n).index_add_(0, index, src.new_ones(index.shape[0]))
    return total / count.clamp(min=1)[:, None]


def conv1x1(seq: nn.Sequential, e: torch.Tensor) -> torch.Tensor:
    """A ``Sequential(Conv1d 1x1, ...)`` over edge rows (E, C)."""
    return seq(e.t().unsqueeze(0)).squeeze(0).t()


class EdgeGCN(nn.Module):
    def __init__(self, dim: int = 512):
        super().__init__()
        mid = dim // 2
        self.node_GConv1 = GCNConv(dim, mid)
        self.node_GConv2 = GCNConv(mid, dim)
        self.edge_MLP1 = nn.Sequential(nn.Conv1d(dim, mid, 1), nn.ReLU())
        self.edge_MLP2 = nn.Sequential(nn.Conv1d(mid, dim, 1), nn.ReLU())
        self.edge_attentionND = nn.Linear(dim, mid)
        self.node_attentionND = nn.Linear(dim, mid)
        self.node_indicator_reduction = nn.Linear(dim, mid)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x, e, ei):  # x (N, D), e (E, D), ei (2, E): [subject, object]
        n = x.shape[0]
        ind = self.edge_attentionND(e)
        gate = torch.sigmoid(scatter_mean(ind, ei[0], n) * scatter_mean(ind, ei[1], n))
        x = self.dropout(F.relu(self.node_GConv1(x, ei)) * gate)
        x = F.relu(self.node_GConv2(x, ei))
        nind = F.relu(self.node_attentionND(x))
        node_gate = torch.sigmoid(self.node_indicator_reduction(
            torch.cat([nind[ei[0]], nind[ei[1]]], dim=-1)))
        e = self.dropout(conv1x1(self.edge_MLP1, e) * node_gate)
        return x, conv1x1(self.edge_MLP2, e)


class ScaledDotProductAttention(nn.Module):
    def __init__(self, d_model: int, h: int):
        super().__init__()
        self.h, self.dk = h, d_model // h
        self.fc_q = nn.Linear(d_model, d_model)
        self.fc_k = nn.Linear(d_model, d_model)
        self.fc_v = nn.Linear(d_model, d_model)
        self.fc_o = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, bias=None):  # (1, n, d); bias (1, h, n, n) added
        b, nq, _ = q.shape
        nk = k.shape[1]
        qh = self.fc_q(q).view(b, nq, self.h, self.dk).permute(0, 2, 1, 3)
        kh = self.fc_k(k).view(b, nk, self.h, self.dk).permute(0, 2, 3, 1)
        vh = self.fc_v(v).view(b, nk, self.h, self.dk).permute(0, 2, 1, 3)
        att = qh @ kh / math.sqrt(self.dk)
        if bias is not None:
            att = att + bias
        out = (att.softmax(-1) @ vh).permute(0, 2, 1, 3).reshape(b, nq, self.h * self.dk)
        return self.fc_o(out)


class MultiHeadAttention(nn.Module):
    """Post-norm residual attention (dropout off in eval mode)."""

    def __init__(self, d_model: int, h: int):
        super().__init__()
        self.attention = ScaledDotProductAttention(d_model, h)
        self.dropout = nn.Dropout(0.1)
        self.layer_norm = nn.LayerNorm(d_model)

    def forward(self, q, k, v, bias=None):
        return self.layer_norm(q + self.dropout(self.attention(q, k, v, bias)))


class MMEdgeGCN(nn.Module):
    def __init__(self, dim: int = 512, heads: int = 8):
        super().__init__()
        self.h = heads
        self.self_attn_fc = nn.Sequential(
            nn.Linear(4, 32), nn.ReLU(), nn.LayerNorm(32), nn.Linear(32, 32), nn.ReLU(),
            nn.LayerNorm(32), nn.Linear(32, heads))
        self.self_attn = MultiHeadAttention(dim, heads)
        self.cross_attn = MultiHeadAttention(dim, heads)
        self.edgegcn_3d = EdgeGCN(dim)
        self.edgegcn_2d = EdgeGCN(dim)
        self.cross_attn_rel = MultiHeadAttention(dim, heads)

    def attend_3d(self, f, centers, nodes):
        """Distance-biased self-attention within each scene (``nodes``: each
        scene's node slice)."""
        out = []
        for a, b in nodes:
            c = centers[a:b]
            delta = c[None, :, :] - c[:, None, :]  # [q, k] = c_k - c_q
            dist = delta.pow(2).sum(-1, keepdim=True).sqrt()
            bias = self.self_attn_fc(torch.cat([delta, dist], -1)).permute(2, 0, 1)[None]
            x = f[None, a:b]
            out.append(self.self_attn(x, x, x, bias)[0])
        return torch.cat(out)


class EdgeMLP(nn.Module):
    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        mid = dim // 2
        self.edge_linear1 = nn.Linear(dim, mid, bias=False)
        self.edge_BnReluDp = nn.Sequential(nn.BatchNorm1d(mid), nn.LeakyReLU(0.2), nn.Dropout())
        self.edge_linear2 = nn.Linear(mid, num_classes, bias=False)

    def forward(self, e):
        return torch.sigmoid(self.edge_linear2(self.edge_BnReluDp(self.edge_linear1(e))))


class Adapter(nn.Module):
    def __init__(self, dim: int = 512, hidden: int = 256, alpha: float = 0.5):
        super().__init__()
        self.alpha = alpha
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.alpha * self.fc2(F.relu(self.fc1(x))) + (1 - self.alpha) * x


def triplet_projector(d_in: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, 1024), nn.Dropout(0.5), nn.ReLU(), nn.Linear(1024, 512))


class SGGpointReference(nn.Module):
    """Every child of the source's ``SGGpoint``; ``forward_3d`` runs the 3D
    branch."""

    CHILDREN = ("backbone", "mlp_3d", "edge_mlp_3d", "clip_adapter", "edge_mlp_2d", "edge_gcn",
                "obj_mlp_3d", "obj_mlp_2d", "rel_mlp_3d", "rel_mlp_2d", "obj_classifier_3d",
                "obj_classifier_2d", "rel_classifier_3d", "rel_classifier_2d",
                "triplet_projector_3d", "triplet_projector_2d")

    def __init__(self, num_obj: int = 160, num_rel: int = 26, dim: int = 512, heads: int = 8,
                 k: int = 20, point_channels: int = 3):
        super().__init__()
        self.backbone = DGCNN(point_channels, BACKBONE, k)
        self.mlp_3d = nn.Linear(BACKBONE, dim - 8)
        self.edge_mlp_3d = nn.Linear(2 * dim, dim - 11)
        self.clip_adapter = Adapter(dim)
        self.edge_mlp_2d = nn.Linear(2 * dim, dim - 11)
        self.edge_gcn = MMEdgeGCN(dim, heads)
        self.obj_mlp_3d = nn.Linear(2 * dim, dim)
        self.obj_mlp_2d = nn.Linear(2 * dim, dim)
        self.rel_mlp_3d = nn.Linear(2 * dim, dim)
        self.rel_mlp_2d = nn.Linear(2 * dim, dim)
        self.obj_logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.obj_classifier_3d = nn.Linear(dim, num_obj, bias=False)
        self.obj_classifier_2d = nn.Linear(dim, num_obj, bias=False)
        self.rel_classifier_3d = EdgeMLP(dim, num_rel)
        self.rel_classifier_2d = EdgeMLP(dim, num_rel)
        self.triplet_projector_3d = triplet_projector(3 * dim)
        self.triplet_projector_2d = triplet_projector(3 * dim)

    def backbone_3d(self, obj_points: torch.Tensor,
                    sets: Optional[Sequence[torch.Tensor]] = None,
                    record: Optional[List] = None) -> torch.Tensor:
        """(M, P, C) instance clouds -> (M, 768) pooled DGCNN features
        (``sets`` and ``record`` as ``DGCNN.forward``'s)."""
        return self.backbone(obj_points.transpose(1, 2), sets, record).max(dim=-1)[0]

    def head_3d(self, pooled: torch.Tensor, blk: Dict) -> Dict[str, torch.Tensor]:
        """The 3D branch after the backbone, over the block ``blk``."""
        desc, ei = blk["descriptor"], blk["edge_index"]
        spatial = desc[:, 3:].clone()
        spatial[:, 6:] = spatial[:, 6:].log()
        f3d = torch.cat([self.mlp_3d(pooled), spatial], dim=-1)
        fi, fj = f3d[ei[:, 0]], f3d[ei[:, 1]]
        d_i, d_j = desc[ei[:, 0]], desc[ei[:, 1]]
        ed = torch.cat([d_i[:, :6] - d_j[:, :6], (d_i[:, 6:] / d_j[:, 6:]).log()], dim=-1)
        e3d = torch.cat([self.edge_mlp_3d(torch.cat([fi, fj - fi], -1)), ed], dim=-1)
        g = self.edge_gcn
        g3 = g.attend_3d(f3d, desc[:, :3], blk["nodes"])
        g3, ge3 = g.edgegcn_3d(g3, e3d, ei.t())
        g3 = self.obj_mlp_3d(torch.cat([f3d, g3], -1))
        ge3 = self.rel_mlp_3d(torch.cat([e3d, ge3], -1))
        unit = g3 / g3.norm(dim=-1, keepdim=True)
        return {"obj_logits_3d": self.obj_logit_scale.exp() * self.obj_classifier_3d(unit),
                "rel_cls_3d": self.rel_classifier_3d(ge3)}

    def forward_3d(self, blk: Dict, sets: Optional[Sequence[torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        return self.head_3d(self.backbone_3d(blk["obj_points"], sets), blk)


def module_state_dicts(model: SGGpointReference) -> Dict[str, Dict[str, object]]:
    """The original checkpoint layout: per direct child its state dict (host
    numpy arrays), and ``obj_logit_scale`` as its own entry."""
    out = {n: {k: v.detach().cpu().numpy() for k, v in getattr(model, n).state_dict().items()}
           for n in model.CHILDREN}
    out["obj_logit_scale"] = {"obj_logit_scale": model.obj_logit_scale.detach().cpu().numpy()}
    return out

