"""MMG graph stacks, dual-branch and 3D-only (counterpart of
``vlsat_tpu/models/mmg.py``).

Per layer: distance-biased 3D node self-attention; 2D node cross-attention
(q = f2d, k/v = the updated f3d, same node mask and distance bias); one
``GraphEdgeAttenNetwork`` per branch; then the 2D edges cross-attend to the
3D edges under the factored ``q_mask``/``k_mask`` pair (the dense (B, 1, E, E)
mask is never built).  ReLU + dropout between layers (and after the only
layer when depth == 1), in the f3d, f2d, e3d, e2d order of the JAX module;
in training mode every dropout mask is drawn from the one ``rng`` generator
in that call order.
``with_2d=False`` runs the 3D path alone; its outputs equal the 3D outputs
of the full stack, since the 2D branch only reads the 3D stream.  In eval
mode that path can run its edge layers on packed edge rows (``edge_rows``).
``MMGSingle`` is the 3D-only variant's stack: GCN layers alone, no attention.
"""

from __future__ import annotations

import torch
from torch import nn

from vlsat_tpu_torch.models.gnn import GraphEdgeAttenNetwork
from vlsat_tpu_torch.models.layers import Dropout
from vlsat_tpu_torch.models.transformer import DistanceBiasMLP, MultiHeadAttention
from vlsat_tpu_torch.ops.attention import pairwise_distance_bias


class MMG(nn.Module):
    def __init__(self, dim_node: int = 512, dim_edge: int = 512, dim_atten: int = 256,
                 num_heads: int = 8, depth: int = 2, aggr: str = "max",
                 dropout_atten: float = 0.5, use_edge: bool = True):
        super().__init__()
        self.depth = depth
        self.self_attn_fc = DistanceBiasMLP(num_heads)
        gcn = lambda: GraphEdgeAttenNetwork(num_heads, dim_node, dim_edge, dim_atten,
                                            aggr=aggr, dropout_atten=dropout_atten,
                                            use_edge=use_edge)
        for i in range(depth):
            self.add_module(f"self_attn_{i}", MultiHeadAttention(num_heads, dim_node))
            self.add_module(f"cross_attn_{i}", MultiHeadAttention(num_heads, dim_node))
            self.add_module(f"gcn_3d_{i}", gcn())
            self.add_module(f"gcn_2d_{i}", gcn())
            self.add_module(f"cross_attn_rel_{i}", MultiHeadAttention(num_heads, dim_edge))
        self.drop = Dropout(dropout_atten)

    def forward(self, f3d, f2d, e3d, e2d, edge_index, obj_mask, edge_mask, obj_center,
                with_2d: bool = True, rng=None, edge_rows=None):
        """``edge_rows`` (an ``ops.graph.EdgeRows``; the 3D path alone, in
        eval mode): ``e3d`` holds the packed edge rows it names, (R, D) in
        and out, and the GCN layers run on them (``forward_packed``)."""
        node_mask = obj_mask[:, None, None, :] & obj_mask[:, None, :, None]
        bias = self.self_attn_fc(pairwise_distance_bias(obj_center.detach()))
        for i in range(self.depth):
            f3d = getattr(self, f"self_attn_{i}")(f3d, f3d, f3d, mask=node_mask, bias=bias,
                                                 rng=rng)
            if with_2d:
                f2d = getattr(self, f"cross_attn_{i}")(f2d, f3d, f3d, mask=node_mask,
                                                      bias=bias, rng=rng)
            gcn_3d = getattr(self, f"gcn_3d_{i}")
            if edge_rows is None:
                f3d, e3d = gcn_3d(f3d, e3d, edge_index, edge_mask, rng)
            else:
                f3d, e3d = gcn_3d.forward_packed(f3d, e3d, edge_rows, edge_index, edge_mask)
            if with_2d:
                f2d, e2d = getattr(self, f"gcn_2d_{i}")(f2d, e2d, edge_index, edge_mask, rng)
                e2d = getattr(self, f"cross_attn_rel_{i}")(e2d, e3d, e3d, q_mask=edge_mask,
                                                          k_mask=edge_mask, rng=rng)
            if i < self.depth - 1 or self.depth == 1:
                f3d = self.drop(torch.relu(f3d), rng)
                if with_2d:
                    f2d = self.drop(torch.relu(f2d), rng)
                e3d = self.drop(torch.relu(e3d), rng)
                if with_2d:
                    e2d = self.drop(torch.relu(e2d), rng)
        return f3d, f2d, e3d, e2d


class MMGSingle(nn.Module):
    """3D-only stack (mmg.py:110-139): ``depth`` ``GraphEdgeAttenNetwork``
    layers ``gcn_3d_{i}``, ReLU + dropout between them (and after the only
    one when depth == 1).  ``dim_in``: the width of the incoming node
    features (504 without the spatial features), ``dim_node`` after the
    first layer."""

    def __init__(self, dim_node: int = 512, dim_edge: int = 512, dim_atten: int = 256,
                 num_heads: int = 8, depth: int = 2, aggr: str = "max",
                 dropout_atten: float = 0.5, use_edge: bool = True,
                 dim_in: int | None = None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"gcn_3d_{i}", GraphEdgeAttenNetwork(
                num_heads, dim_node, dim_edge, dim_atten, aggr=aggr,
                dropout_atten=dropout_atten, use_edge=use_edge,
                dim_in=dim_in if i == 0 else None))
        self.drop = Dropout(dropout_atten)

    def forward(self, f3d, e3d, edge_index, edge_mask, rng=None):
        for i in range(self.depth):
            f3d, e3d = getattr(self, f"gcn_3d_{i}")(f3d, e3d, edge_index, edge_mask, rng)
            if i < self.depth - 1 or self.depth == 1:
                f3d = self.drop(torch.relu(f3d), rng)
                e3d = self.drop(torch.relu(e3d), rng)
        return f3d, e3d
