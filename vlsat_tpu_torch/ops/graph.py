"""Fixed-shape graph gather/scatter primitives.

Counterpart of ``vlsat_tpu/ops/graph.py``.  Gathers are plain index gathers
over padded per-scene edge lists (the JAX package's one-hot matmul gather,
graph.py:30-58, is a TPU workaround and is not carried over).  Scatters route
invalid (padded) edges to a dump segment past the last node.

Empty-segment semantics match torch-scatter: a node with no valid incoming
edge aggregates to 0, while a node whose true max is negative keeps it.

``EdgeRows`` packs a batch's edge rows for the 3D-only eval forward, which
runs its per-edge layers on the rows it names and not on the whole padded
(B, E) grid: ``select_edge_rows`` picks them on the host, ``unpack_edges``
restores (B, E).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from vlsat_tpu_torch.ops.kernels.segment_max import segment_max, segment_max_plain


def gather_edge_endpoints(x: torch.Tensor, edge_index: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, N, D), edge_index (B, E, 2) -> (x_i, x_j), each (B, E, D), with
    x_i = x[edge_index[..., 0]] (the subject)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    ei = edge_index.long()
    return x[b, ei[..., 0]], x[b, ei[..., 1]]


@dataclasses.dataclass(frozen=True)
class EdgeRows:
    """The edge rows of a (B, E) batch that a packed forward computes, R of
    them, in the order of their flat slots ``b * E + e``
    (``select_edge_rows`` picks them on the host):

      ends  (R, 2)   each row's (subject, object) in the batch's flat
                     (B * N) node table
      src   (B * E,) the packed row whose value each slot takes

    ``unpack_edges(packed, src, B)`` is equal, row for row, to the dense
    (B, E, ...) result."""

    ends: torch.Tensor
    src: torch.Tensor


def _kept_rows(edge_mask: np.ndarray, edge_index: np.ndarray):
    """(shared (B, E): the padded rows whose ``edge_index`` is (0, 0), each
    scene's first of them (B,), the kept flat slots (R,))."""
    scenes = np.arange(edge_mask.shape[0])
    shared = ~edge_mask & (edge_index.view(np.int64)[..., 0] == 0)
    first = shared.argmax(axis=1)
    keep = ~shared
    keep[scenes, first] |= shared[scenes, first]
    return shared, first, np.flatnonzero(keep)


def edge_row_slots(edge_mask: np.ndarray, edge_index: np.ndarray) -> np.ndarray:
    """The flat slots ``b * E + e`` of the R rows that ``select_edge_rows``
    keeps, in its order (ascending)."""
    return _kept_rows(edge_mask, np.ascontiguousarray(edge_index, dtype=np.int32))[2]


def select_edge_rows(edge_mask: np.ndarray, edge_index: np.ndarray, num_nodes: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``EdgeRows``' ``ends`` (R, 2) and ``src`` (B * E,), int32 numpy, of
    a host batch's (B, E) ``edge_mask`` and (B, E, 2) ``edge_index`` over
    ``num_nodes`` node slots a scene.  Every valid edge is computed.  The
    padded rows of a scene whose ``edge_index`` is (0, 0) all see the same
    inputs (node 0 at both ends, the same descriptor), so the first of them
    is computed and ``src`` sends the others to it; an invalid row with
    other endpoints is computed on its own."""
    b, e = edge_mask.shape
    edge_index = np.ascontiguousarray(edge_index, dtype=np.int32)
    shared, first, rows = _kept_rows(edge_mask, edge_index)
    ends = edge_index.reshape(-1, 2)[rows] + (rows // e * num_nodes).astype(np.int32)[:, None]
    src = np.empty((b, e), np.int32)
    flat = src.reshape(-1)
    flat[rows] = np.arange(len(rows))
    np.copyto(src, flat[np.arange(b) * e + first][:, None], where=shared)
    return ends, flat


def unpack_edges(packed: torch.Tensor, src: torch.Tensor, batch: int) -> torch.Tensor:
    """(R, ...) packed edge rows -> (B, E, ...) through ``EdgeRows.src``."""
    return packed[src].unflatten(0, (batch, -1))


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
