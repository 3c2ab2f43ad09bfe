"""Shared neural building blocks (counterpart of ``vlsat_tpu/models/layers.py``).

Dense layers are ``nn.Linear`` (weight (out, in)).  ``ChannelDense`` keeps
the JAX package's (C, F) kernel, because it contracts over axis -2.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vlsat_tpu_torch.ops.kernels.pointnet_kernel import pointnet_encode_fused
from vlsat_tpu_torch.ops.pointnet import pointnet_encode
from vlsat_tpu_torch.parallel.mesh import global_rand, global_sum


class DenseStack(nn.Module):
    """Linear chain with ReLU between layers (layers.py:19-40; the port's
    callers use neither its activate-last nor its dropout option)."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"fc{i}", nn.Linear(in_features, f))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class ChannelDense(nn.Module):
    """Dense over the second-to-last axis: (..., C, H) -> (..., F, H), with a
    (C, F) kernel and (F,) bias (layers.py:43-63)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        return torch.einsum("...ch,cf->...fh", x, self.kernel) + self.bias[:, None]


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from the ``torch.Generator`` the
    caller passes as ``rng`` (flax's ``nn.Dropout`` with an explicit key):
    in training mode an element is kept with probability 1 - p and scaled
    by 1 / (1 - p); in eval mode, or at p = 0, the identity.  The global RNG
    is never used, so a seed fixes every mask of a step.  Under a
    data-parallel step each rank draws the global batch's mask and keeps its
    block (``parallel.global_rand``), so the masks equal the unsharded
    step's."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, rng: torch.Generator | None = None):
        if not self.training or self.p == 0.0:
            return x
        if rng is None:
            raise ValueError("dropout in training mode needs a torch.Generator (rng)")
        keep = global_rand(x.shape, rng, x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class HeadMLP(nn.Module):
    """One MLP shared by all heads, over the channel axis of (..., C, H),
    ReLU (+ dropout) between layers (layers.py:66-96)."""

    def __init__(self, in_channels: int, features: Sequence[int],
                 dropout: float | None = None):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"conv{i}", ChannelDense(in_channels, f))
            in_channels = f
        self.drop = Dropout(dropout or 0.0)

    def forward(self, x, rng: torch.Generator | None = None):
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x)
            if i < self.n - 1:
                x = self.drop(torch.relu(x), rng)
        return x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded batch (layers.py:99-132),
    eps 1e-5.  In eval mode it normalises with the running statistics.  In
    training mode it normalises with the biased statistics of the rows
    where ``mask`` is set (n = max(sum(mask), 1)) and moves the running
    statistics in place with momentum 0.1, the variance unbiased by
    n / max(n - 1, 1) (torch's ``BatchNorm1d`` would raise at n = 1, and
    its statistics would count the padding).  Under a data-parallel step
    the sums and the count are global (``parallel.global_sum``), with the
    unsharded formula (mean, then the mean squared deviation), so every
    rank normalises with the global batch's statistics and moves identical
    running statistics."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            w = mask.to(x.dtype)[..., None]
            axes = tuple(range(x.dim() - 1))
            sums = global_sum(torch.cat([(x * w).sum(dim=axes), w.sum().reshape(1)]))
            n = sums[-1].clamp(min=1.0)
            mean = sums[:-1] / n
            var = global_sum((w * torch.square(x - mean)).sum(dim=axes)) / n
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * var * n / (n - 1).clamp(min=1.0))
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class PointNetEncoder(nn.Module):
    """Shared per-point MLP C -> 64 -> 128 -> out_size + max over points
    (layers.py:135-171): (..., P, C) -> (..., out_size), ReLU after every
    layer.  With ``fused`` and in eval mode the three layers run through the
    fused PointNet wrapper (the CUDA kernel on the card)."""

    def __init__(self, in_channels: int, out_size: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.conv1 = nn.Linear(in_channels, 64)
        self.conv2 = nn.Linear(64, 128)
        self.conv3 = nn.Linear(128, out_size)

    def forward(self, pts):
        layers = (self.conv1, self.conv2, self.conv3)
        bs = [l.bias for l in layers]
        ws = [l.weight.t() for l in layers]
        if self.fused and not self.training:
            return pointnet_encode_fused(pts, ws, bs)
        return pointnet_encode(pts, ws, bs)


class AdapterModel(nn.Module):
    """Residual CLIP-feature adapter (layers.py:174-189):
    out = alpha * fc2(relu(fc1(x))) + (1 - alpha) * x."""

    def __init__(self, dim: int = 512, hidden: int = 256, alpha: float = 0.5):
        super().__init__()
        self.alpha = alpha
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.alpha * self.fc2(torch.relu(self.fc1(x))) + (1 - self.alpha) * x
