"""Fixed-shape graph gather/scatter primitives.

Counterpart of ``vlsat_tpu/ops/graph.py``.  Gathers are plain index gathers
over padded per-scene edge lists (the JAX package's one-hot matmul gather,
graph.py:30-58, is a TPU workaround and is not carried over).  Scatters route
invalid (padded) edges to a dump segment past the last node.

Empty-segment semantics match torch-scatter: a node with no valid incoming
edge aggregates to 0, while a node whose true max is negative keeps it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vlsat_tpu_torch.ops.kernels.segment_max import segment_max, segment_max_plain


def gather_edge_endpoints(x: torch.Tensor, edge_index: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, N, D), edge_index (B, E, 2) -> (x_i, x_j), each (B, E, D), with
    x_i = x[edge_index[..., 0]] (the subject)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    ei = edge_index.long()
    return x[b, ei[..., 0]], x[b, ei[..., 1]]


def _scatter_plain(edge_data: torch.Tensor, edge_index: torch.Tensor,
                   edge_mask: torch.Tensor, num_nodes: int, aggr: str,
                   target: int) -> torch.Tensor:
    """Per-scene reduce of (B, E, D) rows onto nodes; invalid edges go to a
    dump segment N that is dropped."""
    if aggr == "max":
        return segment_max_plain(edge_data, edge_index, edge_mask, num_nodes, target)
    if aggr not in ("add", "mean"):
        raise ValueError(f"unknown aggr {aggr!r}")
    b, _, d = edge_data.shape
    seg = torch.where(edge_mask, edge_index[..., target].long(), num_nodes)
    out = edge_data.new_zeros(b, num_nodes + 1, d).scatter_add(
        1, seg[..., None].expand(-1, -1, d), edge_data)
    if aggr == "mean":
        counts = torch.zeros(b, num_nodes + 1, dtype=edge_data.dtype,
                             device=edge_data.device).scatter_add(
            1, seg, torch.ones(seg.shape, dtype=edge_data.dtype, device=seg.device))
        out = out / counts.clamp(min=1.0)[..., None]
    return out[:, :num_nodes]


def scatter_edges_to_nodes(edge_data: torch.Tensor, edge_index: torch.Tensor,
                           edge_mask: torch.Tensor, num_nodes: int,
                           aggr: str = "max", target: int = 0,
                           use_kernel: bool = False) -> torch.Tensor:
    """Aggregate per-edge features onto nodes.

    edge_data (B, E, D), edge_index (B, E, 2), edge_mask (B, E) bool ->
    (B, N, D).  ``target`` selects the endpoint that receives the message
    (0 = subject).  ``use_kernel`` (callers pass it at eval, as the JAX
    package passes ``use_pallas=deterministic``) routes aggr="max" through
    the ``vlsat::segment_max`` operator: the CUDA kernel on a CUDA tensor,
    its plain twin on a CPU tensor, the plain scatter's gradient on both.
    """
    if use_kernel and aggr == "max":
        return segment_max(edge_data, edge_index, edge_mask, num_nodes, target)
    return _scatter_plain(edge_data, edge_index, edge_mask, num_nodes, aggr, target)
