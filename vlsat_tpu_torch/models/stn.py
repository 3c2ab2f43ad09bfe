"""Spatial transformer networks (counterpart of ``vlsat_tpu/models/stn.py``):
a KxK transform predicted from a point set by a shared per-point MLP, a max
over the points and an FC head whose last layer starts at zero, so that the
transform starts at the identity.  No shipped config enables them; they are
kept for ablations, as in JAX."""

from __future__ import annotations

import torch
from torch import nn

from vlsat_tpu_torch.parallel.mesh import global_sum


class STNkd(nn.Module):
    """(..., P, k) -> (..., k, k): conv 64, 128, 1024 (ReLU) over the
    points, max over P, fc 512, 256 (ReLU), fc k*k (zero-initialised) plus
    the identity."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.k = k
        self.conv1 = nn.Linear(k, 64)
        self.conv2 = nn.Linear(64, 128)
        self.conv3 = nn.Linear(128, 1024)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k * k)
        nn.init.zeros_(self.fc3.weight)
        nn.init.zeros_(self.fc3.bias)

    def forward(self, pts):
        x = torch.relu(self.conv1(pts))
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.conv3(x)).amax(dim=-2)
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        x = self.fc3(x) + torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(-1)
        return x.unflatten(-1, (self.k, self.k))


def STN3d() -> STNkd:  # noqa: N802 (the reference's name)
    return STNkd(k=3)


def apply_transform(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., P, k) x (..., k, k) -> (..., P, k)."""
    return torch.matmul(pts, trans)


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """mean over the global batch's transforms of ||T T^t - I||_F."""
    eye = torch.eye(trans.shape[-1], dtype=trans.dtype, device=trans.device)
    diff = torch.matmul(trans, trans.transpose(-1, -2)) - eye
    norms = torch.sqrt(torch.sum(diff * diff, dim=(-2, -1)))
    return norms.sum() / global_sum(norms.new_tensor(float(norms.numel())))
