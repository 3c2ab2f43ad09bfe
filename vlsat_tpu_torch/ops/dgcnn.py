"""DGCNN primitives: the kNN graph and the EdgeConv input (counterpart of
``vlsat_tpu/ops/dgcnn.py:14,26``), batched over (..., P, C) point sets.

Which of two nearly equidistant points ``torch.topk`` keeps can differ from
``jax.lax.top_k``, and between the CPU and the card, since each rounds the
distance matrix its own way.  The EdgeConv takes a max over the k
neighbours, so only the neighbour *set* matters; padded (all-zero) clouds
and duplicate points give equal features whichever of the tied points is
kept.
"""

from __future__ import annotations

import torch


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (..., P, C) -> (..., P, k) indices of the k nearest points, the
    point itself included, from -|xi - xj|^2 = 2 xi.xj - |xi|^2 - |xj|^2
    (the reference's and the JAX package's form)."""
    inner = 2.0 * torch.matmul(x, x.transpose(-1, -2))
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    neg_dist = inner - sq - sq.transpose(-1, -2)
    return torch.topk(neg_dist, k, dim=-1).indices


def graph_feature(x: torch.Tensor, k: int = 20, idx: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """EdgeConv input: (..., P, C) -> (..., P, k, 2C) = [x_j - x_i, x_i]."""
    if idx is None:
        idx = knn_indices(x, k)
    *lead, p, c = x.shape
    flat = x.reshape(-1, p, c)
    rows = torch.arange(flat.shape[0], device=x.device)[:, None, None]
    gathered = flat[rows, idx.reshape(-1, p, idx.shape[-1])].reshape(*lead, p, -1, c)
    center = x[..., :, None, :].expand_as(gathered)
    return torch.cat([gathered - center, center], dim=-1)
