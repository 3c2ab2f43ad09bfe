"""Instance / edge spatial descriptors (counterpart of
``vlsat_tpu/ops/descriptor.py:17-44``)."""

from __future__ import annotations

import torch

from vlsat_tpu_torch.ops.graph import gather_edge_endpoints


def gen_descriptor(pts: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) raw points -> (..., 11) = [centroid(3), std(3), bbox
    dims(3), volume(1), max length(1)]; std is the ddof=1 estimator."""
    centroid = pts.mean(dim=-2)
    var = torch.square(pts - centroid[..., None, :]).sum(dim=-2) / (pts.shape[-2] - 1)
    dims = pts.amax(dim=-2) - pts.amin(dim=-2)
    volume = torch.prod(dims, dim=-1, keepdim=True)
    length = dims.amax(dim=-1, keepdim=True)
    return torch.cat([centroid, torch.sqrt(var), dims, volume, length], dim=-1)


def edge_descriptor(descriptor: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """(B, N, 11), (B, E, 2) -> (B, E, 11) = [d centroid(3), d std(3), log
    dim ratio(3), log volume ratio(1), log length ratio(1)], subject minus
    object."""
    d_i, d_j = gather_edge_endpoints(descriptor, edge_index)
    delta = d_i[..., 0:6] - d_j[..., 0:6]
    log_ratio = torch.log(d_i[..., 6:11] / d_j[..., 6:11])
    return torch.cat([delta, log_ratio], dim=-1)
