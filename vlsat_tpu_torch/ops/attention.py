"""Masked scaled-dot-product attention with an optional additive bias.

Counterpart of ``vlsat_tpu/ops/attention.py`` (``masked_attention`` :80-111,
``masked_attention_bnhd`` :114-177, ``pairwise_distance_bias`` :180-191).
Scenes are a batch axis, so the reference's per-scene block-diagonal mask is
a padding mask.  Rows with no valid key return zeros, not NaN.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30

# Score sizes above which the JAX package routes to its library attention
# (attention.py:37-38).  The same gate is kept so both packages take the
# same route on the same shapes; 3D-only serving never reaches it.
LARGE_SCORE_SLICE = 7 * 1024 * 1024
LARGE_SCORE_ELEMENTS = 2 * 1024 * 1024 * 1024


def _sdpa_large(q, k, v, mask, bias, q_mask=None, k_mask=None):
    """Large-score route through ``F.scaled_dot_product_attention``, with the
    handwritten core's semantics: a query row with no valid key returns
    zeros (the library would softmax an all-masked row into NaN), including
    a row emptied only by ``mask & k_mask`` (attention.py:41-77)."""
    any_k = None
    if k_mask is not None:
        any_k = k_mask.any(dim=-1, keepdim=True)               # (B, 1)
    any_valid = None
    if mask is not None:
        if k_mask is not None:
            mask = mask & k_mask[:, None, None, :]
        any_valid = mask.any(dim=-1, keepdim=True)              # (B, 1|H, Nq, 1)
        mask = mask | ~any_valid
    elif k_mask is not None:
        mask = (k_mask | ~any_k)[:, None, None, :]
    attn_mask = None
    if mask is not None:
        attn_mask = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(
            ~mask, float("-inf"))
    if bias is not None:
        attn_mask = bias if attn_mask is None else attn_mask + bias
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=attn_mask).transpose(1, 2)                    # (B, Nq, H, Dv)
    if any_valid is not None:
        out = torch.where(any_valid.movedim(1, 2), out, 0.0)
    if k_mask is not None:
        out = torch.where(any_k[:, :, None, None], out, 0.0)
    if q_mask is not None:
        out = torch.where(q_mask[:, :, None, None], out, 0.0)
    return out


def masked_attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mask: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None,
                          bias_way: str = "add",
                          q_mask: torch.Tensor | None = None,
                          k_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Head-last attention core: q/k/v (B, N, H, D) -> (B, Nq, H, Dv).

    mask/bias broadcast to (B, H, Nq, Nk); True = attend.  ``bias_way`` is
    'add' (pre-softmax add) or 'mul'.  ``q_mask``/``k_mask`` ((B, Nq)/(B, Nk)
    bool) are the factored form of the rectangular mask q_mask & k_mask.
    """
    b, h = q.shape[0], q.shape[-2]
    slice_scores = q.shape[-3] * k.shape[-3]
    large = slice_scores >= LARGE_SCORE_SLICE or b * h * slice_scores >= LARGE_SCORE_ELEMENTS
    if large and (bias is None or bias_way == "add"):
        return _sdpa_large(q, k, v, mask, bias, q_mask=q_mask, k_mask=k_mask)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        att = att + bias if bias_way == "add" else att * bias
    kp = None
    if k_mask is not None:
        kp = k_mask[:, None, None, :]
        att = torch.where(kp, att, NEG_INF)
    if mask is not None:
        att = torch.where(mask, att, NEG_INF)
    att = torch.exp(att - att.amax(dim=-1, keepdim=True))
    if kp is not None:
        att = torch.where(kp, att, 0.0)
    if mask is not None:
        att = torch.where(mask, att, 0.0)
    att = att / att.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    out = torch.einsum("bhqk,bkhv->bqhv", att, v)
    if q_mask is not None:
        out = torch.where(q_mask[:, :, None, None], out, 0.0)
    return out


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mask: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     bias_way: str = "add") -> torch.Tensor:
    """Head-second attention core: q (B, H, Nq, Dk), k (B, H, Nk, Dk),
    v (B, H, Nk, Dv) -> (B, H, Nq, Dv).

    mask/bias broadcast to (B, H, Nq, Nk); True = attend.  Scores are scaled
    by sqrt(Dk), the bias is applied before the mask ('add' or 'mul'), and a
    row whose keys are all masked gives zeros, as in ``masked_attention_bnhd``,
    which computes it on the head-last views.
    """
    out = masked_attention_bnhd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                mask=mask, bias=bias, bias_way=bias_way)
    return out.transpose(1, 2)


def pairwise_distance_bias(centers: torch.Tensor) -> torch.Tensor:
    """centers (B, N, 3) -> (B, N, N, 4): entry [b, q, k] holds
    centers[k] - centers[q] followed by the Euclidean distance."""
    delta = centers[:, None, :, :] - centers[:, :, None, :]
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1, keepdim=True) + 1e-24)
    return torch.cat([delta, dist], dim=-1)
