"""Graph edge-attention network and the triplet GCN (counterpart of
``vlsat_tpu/models/gnn.py``).

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

from vlsat_tpu_torch.models.layers import DenseStack, HeadMLP, MaskedBatchNorm
from vlsat_tpu_torch.ops.graph import (gather_edge_endpoints, scatter_edges_to_nodes,
                                       unpack_edges)


class FatEdgeAttention(nn.Module):
    """Edge update + feature-gated message of one edge-attention layer."""

    def __init__(self, num_heads: int, dim_node: int, dim_edge: int,
                 dim_atten: int, dropout_atten: float | None = 0.5,
                 use_edge: bool = True, dim_in: int | None = None):
        super().__init__()
        h = num_heads
        self.h = h
        self.d_n, self.d_e, self.d_o = dim_node // h, dim_edge // h, dim_atten // h
        self.use_edge = use_edge
        hid = dim_node + dim_edge
        dim_in = dim_in or dim_node
        self.nn_edge_fc0_edge = nn.Linear(dim_edge, hid)
        self.nn_edge_fc1 = nn.Linear(hid, dim_edge)
        self.proj_value = DenseStack(dim_in, [dim_atten])
        self.proj_query = DenseStack(dim_in, [dim_node])
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
    as in JAX (gnn.py:163-168).  ``dim_in``: the width of the incoming node
    features where it is not ``dim_node`` (flax infers it; the output is
    ``dim_node`` wide either way)."""

    def __init__(self, num_heads: int, dim_node: int, dim_edge: int,
                 dim_atten: int, aggr: str = "max",
                 dropout_atten: float | None = 0.5, use_edge: bool = True,
                 dim_in: int | None = None):
        super().__init__()
        self.aggr = aggr
        hid = dim_node + dim_edge
        dim_in = dim_in or dim_node
        self.edgeatten = FatEdgeAttention(num_heads, dim_node, dim_edge, dim_atten,
                                          dropout_atten=dropout_atten, use_edge=use_edge,
                                          dim_in=dim_in)
        self.edgeatten_nn_edge_fc0_node_i = nn.Linear(dim_in, hid, bias=False)
        self.edgeatten_nn_edge_fc0_node_j = nn.Linear(dim_in, hid, bias=False)
        self.prop = DenseStack(dim_in + dim_atten, [dim_node + dim_atten, dim_node])

    def forward(self, x, edge_feature, edge_index, edge_mask, rng=None):
        x_i, x_j = gather_edge_endpoints(x, edge_index)
        msg, edge_new = self._edges(x_i, edge_feature, x_j, rng)
        return self._nodes(x, msg, edge_index, edge_mask), edge_new

    def forward_packed(self, x, edge_feature, edge_rows, edge_index, edge_mask):
        """The eval-mode layer on the packed edge rows of ``edge_rows`` (an
        ``ops.graph.EdgeRows``): ``edge_feature`` (R, D) in, the updated (x,
        (R, D) edge_feature) out.  The messages go back to the (B, E, D)
        layout for the aggregation."""
        flat, ends = x.flatten(0, 1), edge_rows.ends
        msg, edge_new = self._edges(flat[ends[:, 0]], edge_feature, flat[ends[:, 1]])
        msg = unpack_edges(msg, edge_rows.src, x.shape[0])
        return self._nodes(x, msg, edge_index, edge_mask), edge_new

    def _edges(self, x_i, edge_feature, x_j, rng=None):
        nodes = (self.edgeatten_nn_edge_fc0_node_i(x_i),
                 self.edgeatten_nn_edge_fc0_node_j(x_j))
        return self.edgeatten(x_i, edge_feature, x_j, nodes, rng)

    def _nodes(self, x, msg, edge_index, edge_mask):
        agg = scatter_edges_to_nodes(msg, edge_index, edge_mask, num_nodes=x.shape[1],
                                     aggr=self.aggr, use_kernel=not self.training)
        return self.prop(torch.cat([x, agg], dim=-1))


class TripletGCN(nn.Module):
    """Graph-triple convolution (gnn.py:175-227, with its defaults: add
    aggregation and BatchNorm): message nn1([x_i, e, x_j]) split into
    (new_i | new_e | new_j), node update x + nn2(the sum of new_i + new_j
    over the edges whose TARGET (edge_index[..., 1]) is the node).  nn1 has
    BatchNorm over the valid edges and ReLU after both layers; nn2 has them
    between its layers only, its BatchNorm over every node row (padding
    included), as the JAX module's all-ones mask does."""

    def __init__(self, dim_node: int, dim_edge: int, dim_hidden: int):
        super().__init__()
        self.dh, self.de = dim_hidden, dim_edge
        self.nn1_fc0 = nn.Linear(2 * dim_node + dim_edge, dim_hidden)
        self.nn1_bn0 = MaskedBatchNorm(dim_hidden)
        self.nn1_fc1 = nn.Linear(dim_hidden, 2 * dim_hidden + dim_edge)
        self.nn1_bn1 = MaskedBatchNorm(2 * dim_hidden + dim_edge)
        self.nn2_fc0 = nn.Linear(dim_hidden, dim_hidden)
        self.nn2_bn0 = MaskedBatchNorm(dim_hidden)
        self.nn2_fc1 = nn.Linear(dim_hidden, dim_node)

    def forward(self, x, edge_feature, edge_index, edge_mask):
        x_j, x_i = gather_edge_endpoints(x, edge_index)  # j = edge[0], i = edge[1]
        h = torch.relu(self.nn1_bn0(self.nn1_fc0(torch.cat([x_i, edge_feature, x_j], dim=-1)),
                                    edge_mask))
        h = torch.relu(self.nn1_bn1(self.nn1_fc1(h), edge_mask))
        dh, de = self.dh, self.de
        agg = scatter_edges_to_nodes(h[..., :dh] + h[..., dh + de:], edge_index, edge_mask,
                                     num_nodes=x.shape[1], aggr="add", target=1)
        g = self.nn2_fc0(agg)
        g = torch.relu(self.nn2_bn0(g, torch.ones(g.shape[:-1], dtype=torch.bool,
                                                  device=g.device)))
        return x + self.nn2_fc1(g), h[..., dh:dh + de]


class TripletGCNModel(nn.Module):
    """A stack of ``TripletGCN`` layers with ReLU between them
    (gnn.py:230-244)."""

    def __init__(self, num_layers: int, dim_node: int, dim_edge: int, dim_hidden: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"gconv_{i}", TripletGCN(dim_node, dim_edge, dim_hidden))

    def forward(self, x, e, edge_index, edge_mask):
        for i in range(self.num_layers):
            x, e = getattr(self, f"gconv_{i}")(x, e, edge_index, edge_mask)
            if i < self.num_layers - 1:
                x, e = torch.relu(x), torch.relu(e)
        return x, e
