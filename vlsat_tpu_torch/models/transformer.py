"""Post-norm multi-head attention, the distance-bias MLP and the sinusoid
position tables (counterpart of ``vlsat_tpu/models/transformer.py``).

The epsilon of every LayerNorm is a field of the model's build
(``ln_eps`` of its config; ``set_layer_norm_eps`` applies it): the
original's torch ``nn.LayerNorm`` uses 1e-5 (``TORCH_LN_EPS``), which the
registry builds; the JAX package's flax LayerNorms use 1e-6
(``FLAX_LN_EPS``), which the config dataclasses default to and which
``interop.from_flax`` gives a model it bridges flax weights into.
"""

from __future__ import annotations

import torch
from torch import nn

from vlsat_tpu_torch.models.layers import Dropout
from vlsat_tpu_torch.ops.attention import masked_attention_bnhd

FLAX_LN_EPS = 1e-6  # flax.linen.LayerNorm's default
TORCH_LN_EPS = 1e-5  # torch.nn.LayerNorm's default, the original's


def set_layer_norm_eps(module: nn.Module, eps: float) -> nn.Module:
    """Set the epsilon of every ``nn.LayerNorm`` inside ``module``; returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.eps = float(eps)
    return module


class MultiHeadAttention(nn.Module):
    """out = LayerNorm(q + Dropout(fc_o(attention(q, k, v)))), head-last
    layout.  mask: (B, 1|H, Nq, Nk) bool; bias: additive or multiplicative
    weights broadcastable to (B, H, Nq, Nk); ``rng`` draws the dropout mask
    in training mode."""

    def __init__(self, num_heads: int, d_model: int, dropout: float = 0.1,
                 d_in: int | None = None):
        super().__init__()
        self.h, self.dk = num_heads, d_model // num_heads
        d_in = d_in or d_model
        hd = self.h * self.dk
        self.fc_q = nn.Linear(d_in, hd)
        self.fc_k = nn.Linear(d_in, hd)
        self.fc_v = nn.Linear(d_in, hd)
        self.fc_o = nn.Linear(hd, d_model)
        self.drop = Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, q, k, v, *, mask=None, bias=None, bias_way="add",
                q_mask=None, k_mask=None, rng=None):
        split = lambda fc, x: fc(x).unflatten(-1, (self.h, self.dk))
        out = masked_attention_bnhd(split(self.fc_q, q), split(self.fc_k, k),
                                    split(self.fc_v, v), mask=mask, bias=bias,
                                    bias_way=bias_way, q_mask=q_mask, k_mask=k_mask)
        out = self.drop(self.fc_o(out.flatten(-2)), rng)
        return self.layer_norm(q + out)


def position_embedding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoid position embedding (transformer.py:55-66): even channels
    sin, odd channels cos, frequency 10000^(2i/d).  (P,) -> (P, d_model)."""
    pos = positions.reshape(-1, 1).to(torch.float32)
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=pos.device).reshape(1, -1)
    angle = pos / torch.pow(10000.0, 2 * dim / d_model)
    out = torch.zeros(pos.shape[0], d_model, device=pos.device)
    out[:, ::2] = torch.sin(angle)
    out[:, 1::2] = torch.cos(angle)
    return out


def sinusoid_encoding_table(max_len: int, d_model: int,
                            padding_idx: int | None = None) -> torch.Tensor:
    """(max_len, d_model) table of ``position_embedding``; the row at
    ``padding_idx`` is zero (transformer.py:69-75)."""
    out = position_embedding(torch.arange(max_len), d_model)
    if padding_idx is not None:
        out[padding_idx] = 0.0
    return out


class PositionWiseFeedForward(nn.Module):
    """Post-norm residual FFN (transformer.py:78-92):
    LayerNorm(x + Dropout(fc2(Dropout(relu(fc1(x))))))."""

    def __init__(self, d_model: int = 512, d_ff: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)
        self.drop = Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, x, rng=None):
        h = self.drop(torch.relu(self.fc1(x)), rng)
        return self.layer_norm(x + self.drop(self.fc2(h), rng))


class DistanceBiasMLP(nn.Module):
    """[dxyz, dist] (B, N, N, 4) -> per-head additive bias (B, H, N, N):
    Linear(4, 32), ReLU, LayerNorm, Linear(32, 32), ReLU, LayerNorm,
    Linear(32, heads)."""

    def __init__(self, num_heads: int):
        super().__init__()
        self.fc0 = nn.Linear(4, 32)
        self.ln0 = nn.LayerNorm(32, eps=FLAX_LN_EPS)
        self.fc1 = nn.Linear(32, 32)
        self.ln1 = nn.LayerNorm(32, eps=FLAX_LN_EPS)
        self.fc2 = nn.Linear(32, num_heads)

    def forward(self, w):
        w = self.ln0(torch.relu(self.fc0(w)))
        w = self.ln1(torch.relu(self.fc1(w)))
        return self.fc2(w).movedim(-1, 1)
