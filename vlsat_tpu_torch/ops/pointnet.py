"""Functional PointNet encoder: shared per-point MLP + max-pool.

Counterpart of ``vlsat_tpu/ops/pointnet.py:26-41`` (``pointnet_encode``).
It is the plain twin of the fused CUDA kernel in
``vlsat_tpu_torch/ops/kernels/pointnet_kernel.py`` and the path training
will differentiate.
"""

from __future__ import annotations

from typing import Sequence

import torch


def pointnet_encode(pts: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """pts: (..., P, C) -> (..., out).

    weights[i]: (C_in, C_out) kernels; ReLU after every layer, including
    the last one before the max over points.
    """
    x = pts
    for w, b in zip(weights, biases):
        x = torch.relu(x @ w + b)
    return x.amax(dim=-2)
