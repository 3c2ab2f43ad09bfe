"""Graph edge-attention network (counterpart of
``vlsat_tpu/models/gnn.py:30-172``).

As in the JAX package: the gate is a softmax over the FEATURE axis of each
edge, not over neighbours; heads are interleaved along the feature axis
(``reshape(d, h)``), and the (d_o, h) gate is flattened the same way;
messages land on the subject node (edge_index[..., 0]).  The first nn_edge
layer is applied per edge to the gathered endpoints (the JAX "edge" mode)
and the gate runs in the (..., C, H) "channel" layout; the JAX package's
other modes compute the same function with other TPU layouts.
"""

from __future__ import annotations

import torch
from torch import nn

from vlsat_tpu_torch.models.layers import DenseStack, HeadMLP
from vlsat_tpu_torch.ops.graph import gather_edge_endpoints, scatter_edges_to_nodes


class FatEdgeAttention(nn.Module):
    """Edge update + feature-gated message of one edge-attention layer."""

    def __init__(self, num_heads: int, dim_node: int, dim_edge: int,
                 dim_atten: int, dropout_atten: float | None = 0.5,
                 use_edge: bool = True):
        super().__init__()
        h = num_heads
        self.h = h
        self.d_n, self.d_e, self.d_o = dim_node // h, dim_edge // h, dim_atten // h
        self.use_edge = use_edge
        hid = dim_node + dim_edge
        self.nn_edge_fc0_edge = nn.Linear(dim_edge, hid)
        self.nn_edge_fc1 = nn.Linear(hid, dim_edge)
        self.proj_value = DenseStack(dim_node, [dim_atten])
        self.proj_query = DenseStack(dim_node, [dim_node])
        self.proj_edge = DenseStack(dim_edge, [dim_edge])
        if use_edge:
            c_in, feats = self.d_n + self.d_e, [self.d_n + self.d_e, self.d_o]
        else:
            c_in, feats = self.d_n, [2 * self.d_n, self.d_o]
        self.nn = HeadMLP(c_in, feats, dropout=dropout_atten)

    def forward(self, x_i, edge, x_j, nn_edge_nodes, rng=None):
        """``nn_edge_nodes``: (proj_i, proj_j), the node-side parts of the
        first nn_edge layer, supplied by the caller; ``rng`` draws the gate
        MLP's dropout mask in training mode."""
        pi, pj = nn_edge_nodes
        edge_new = self.nn_edge_fc1(torch.relu(pi + self.nn_edge_fc0_edge(edge) + pj))
        value = self.proj_value(x_j)
        q = self.proj_query(x_i).unflatten(-1, (self.d_n, self.h))
        gate_in = q
        if self.use_edge:
            e = self.proj_edge(edge).unflatten(-1, (self.d_e, self.h))
            gate_in = torch.cat([q, e], dim=-2)               # (..., d_n+d_e, H)
        prob = torch.softmax(self.nn(gate_in, rng), dim=-2)   # feature axis
        return prob.flatten(-2) * value, edge_new


class GraphEdgeAttenNetwork(nn.Module):
    """One GCN layer: gather -> fat edge attention -> scatter -> residual
    MLP.  x (B, N, D), edge_feature (B, E, D) -> updated (x, edge_feature).
    In eval mode the max aggregation goes through the segment-max wrapper
    (the CUDA kernel on the card), as the JAX package routes
    ``use_pallas=deterministic``; in training mode it is the plain scatter,
    as in JAX (gnn.py:163-168)."""

    def __init__(self, num_heads: int, dim_node: int, dim_edge: int,
                 dim_atten: int, aggr: str = "max",
                 dropout_atten: float | None = 0.5, use_edge: bool = True):
        super().__init__()
        self.aggr = aggr
        hid = dim_node + dim_edge
        self.edgeatten = FatEdgeAttention(num_heads, dim_node, dim_edge, dim_atten,
                                          dropout_atten=dropout_atten, use_edge=use_edge)
        self.edgeatten_nn_edge_fc0_node_i = nn.Linear(dim_node, hid, bias=False)
        self.edgeatten_nn_edge_fc0_node_j = nn.Linear(dim_node, hid, bias=False)
        self.prop = DenseStack(dim_node + dim_atten, [dim_node + dim_atten, dim_node])

    def forward(self, x, edge_feature, edge_index, edge_mask, rng=None):
        x_i, x_j = gather_edge_endpoints(x, edge_index)
        nodes = (self.edgeatten_nn_edge_fc0_node_i(x_i),
                 self.edgeatten_nn_edge_fc0_node_j(x_j))
        msg, edge_new = self.edgeatten(x_i, edge_feature, x_j, nodes, rng)
        agg = scatter_edges_to_nodes(msg, edge_index, edge_mask, num_nodes=x.shape[1],
                                     aggr=self.aggr, use_kernel=not self.training)
        return self.prop(torch.cat([x, agg], dim=-1)), edge_new
