"""DGCNN primitives: the kNN graph and the EdgeConv input (counterpart of
``vlsat_tpu/ops/dgcnn.py:14,26``), batched over (..., P, C) point sets,
and the projection of the factored EdgeConv (``project_pairs``, which
``ops.kernels.edgeconv`` takes).

Which of two nearly equidistant points ``torch.topk`` keeps can differ from
``jax.lax.top_k``, and between the CPU and the card, since each rounds the
distance matrix its own way.  The EdgeConv takes a max over the k
neighbours, so only the neighbour *set* matters; padded (all-zero) clouds
and duplicate points give equal features whichever of the tied points is
kept.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (..., P, C) -> (..., P, k) indices of the k nearest points, the
    point itself included, from -|xi - xj|^2 = 2 xi.xj - |xi|^2 - |xj|^2
    (the reference's and the JAX package's form)."""
    inner = 2.0 * torch.matmul(x, x.transpose(-1, -2))
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    neg_dist = inner - sq - sq.transpose(-1, -2)
    return torch.topk(neg_dist, k, dim=-1).indices


def neighbours(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., P, C), idx (..., P, k) -> (..., P, k, C): row idx[..., i, s]
    of each point set."""
    *lead, p, c = x.shape
    flat = x.reshape(-1, p, c)
    rows = torch.arange(flat.shape[0], device=x.device)[:, None, None]
    return flat[rows, idx.reshape(-1, p, idx.shape[-1])].reshape(*lead, p, -1, c)


def graph_feature(x: torch.Tensor, k: int = 20, idx: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """EdgeConv input: (..., P, C) -> (..., P, k, 2C) = [x_j - x_i, x_i]."""
    if idx is None:
        idx = knn_indices(x, k)
    gathered = neighbours(x, idx)
    center = x[..., :, None, :].expand_as(gathered)
    return torch.cat([gathered - center, center], dim=-1)


def project_pairs(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The factored EdgeConv's one projection of each point.  ``weight``
    (C_out, 2 C_in) is the 1x1 convolution of [x_j - x_i, x_i], W = [W1 |
    W2], which equals (u_j - u_i) + w_i with u = x W1^T and w = x W2^T.
    x (..., P, C_in) -> (..., P, 2 C_out), u_c at column 2c and w_c at
    2c + 1: one product by W's rows viewed as (2 C_out, C_in), no copy and
    no arithmetic on the weight."""
    c_out, c2 = weight.shape
    return F.linear(x, weight.reshape(2 * c_out, c2 // 2))
