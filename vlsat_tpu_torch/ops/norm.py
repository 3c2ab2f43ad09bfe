"""NaN-safe L2 normalization (counterpart of ``vlsat_tpu/ops/norm.py``).

``x * rsqrt(sum(x^2) + eps)`` rather than ``x / norm``: the latter has a NaN
gradient at exactly-zero rows, which padded rows can be.
"""

from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)
