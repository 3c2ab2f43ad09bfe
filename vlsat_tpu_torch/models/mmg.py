"""MMG graph stack, 3D branch (counterpart of ``vlsat_tpu/models/mmg.py:33-107``
with ``with_2d=False``, the deployment protocol).

Per layer: distance-biased node self-attention, then one
``GraphEdgeAttenNetwork``; ReLU + dropout between layers (and after the only
layer when depth == 1).  The 2D cross-attentions and GCNs come with the
dual-branch slice.
"""

from __future__ import annotations

import torch
from torch import nn

from vlsat_tpu_torch.models.gnn import GraphEdgeAttenNetwork
from vlsat_tpu_torch.models.transformer import DistanceBiasMLP, MultiHeadAttention
from vlsat_tpu_torch.ops.attention import pairwise_distance_bias


class MMG(nn.Module):
    def __init__(self, dim_node: int = 512, dim_edge: int = 512, dim_atten: int = 256,
                 num_heads: int = 8, depth: int = 2, aggr: str = "max",
                 dropout_atten: float = 0.5, use_edge: bool = True):
        super().__init__()
        self.depth = depth
        self.self_attn_fc = DistanceBiasMLP(num_heads)
        for i in range(depth):
            self.add_module(f"self_attn_{i}", MultiHeadAttention(num_heads, dim_node))
            self.add_module(f"gcn_3d_{i}", GraphEdgeAttenNetwork(
                num_heads, dim_node, dim_edge, dim_atten, aggr=aggr,
                dropout_atten=dropout_atten, use_edge=use_edge))
        self.drop = nn.Dropout(dropout_atten)

    def forward(self, f3d, e3d, edge_index, obj_mask, edge_mask, obj_center):
        node_mask = obj_mask[:, None, None, :] & obj_mask[:, None, :, None]
        bias = self.self_attn_fc(pairwise_distance_bias(obj_center.detach()))
        for i in range(self.depth):
            f3d = getattr(self, f"self_attn_{i}")(f3d, f3d, f3d, mask=node_mask, bias=bias)
            f3d, e3d = getattr(self, f"gcn_3d_{i}")(f3d, e3d, edge_index, edge_mask)
            if i < self.depth - 1 or self.depth == 1:
                f3d = self.drop(torch.relu(f3d))
                e3d = self.drop(torch.relu(e3d))
        return f3d, e3d
