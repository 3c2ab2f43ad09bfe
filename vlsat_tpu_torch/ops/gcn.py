"""Symmetric-normalised graph convolution, GCNConv with self-loops
(counterpart of ``vlsat_tpu/ops/gcn.py:21,34``):

    out_i = sum_j  A_ij / sqrt(d_i d_j) * x_j   (A includes I; d = 1 + in-degree)

over padded per-scene edge lists; invalid edges add nothing and padded
nodes keep degree 1 (their self-loop).  The sums are ``scatter_add``s,
whose order on the card is not fixed from run to run.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vlsat_tpu_torch.ops.graph import gather_edge_endpoints, scatter_edges_to_nodes


def gcn_normalize_adj(edge_index: torch.Tensor, edge_mask: torch.Tensor,
                      num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, E) per-edge coefficients 1 / sqrt(d_src d_dst) and (B, N)
    self-loop coefficients 1 / d, with d the in-degree (target 1) over
    valid edges plus one."""
    ones = edge_mask.to(torch.float32)[..., None]
    deg = scatter_edges_to_nodes(ones, edge_index, edge_mask, num_nodes,
                                 aggr="add", target=1)[..., 0] + 1.0
    ei = edge_index.long()
    d_src = torch.gather(deg, 1, ei[..., 0])
    d_dst = torch.gather(deg, 1, ei[..., 1])
    return torch.rsqrt(d_src * d_dst), 1.0 / deg


def gcn_propagate(x: torch.Tensor, edge_index: torch.Tensor,
                  edge_mask: torch.Tensor) -> torch.Tensor:
    """x (B, N, D) -> the normalised aggregation; messages flow from the
    source (``edge_index[..., 0]``) to the target (``[..., 1]``), as in
    torch-geometric."""
    n = x.shape[1]
    edge_norm, self_norm = gcn_normalize_adj(edge_index, edge_mask, n)
    x_src, _ = gather_edge_endpoints(x, edge_index)
    agg = scatter_edges_to_nodes(x_src * edge_norm.to(x.dtype)[..., None], edge_index,
                                 edge_mask, n, aggr="add", target=1)
    return agg + x * self_norm.to(x.dtype)[..., None]
