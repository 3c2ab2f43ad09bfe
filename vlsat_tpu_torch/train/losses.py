"""Training losses of the VL-SAT objective (counterpart of
``vlsat_tpu/train/losses.py``).

  total = lambda_o * (CE_obj_2d + CE_obj_3d)
        + 3 * lambda_r * (BCE_rel_2d + BCE_rel_3d)   [DYNAMIC class weights]
        + 0.1 * (mimic + rel_mimic_2d)

Written in plain torch from the JAX formulas, not from library losses: the
BCE clips probabilities to [1e-7, 1 - 1e-7] (``F.binary_cross_entropy``
clamps the log at -100 instead), and every mean is over valid nodes or
edges, counted over the broadcast elements (valid edges x classes for the
BCE).  Nothing here reads a value back to the host.

Every denominator and class count is a ``parallel.global_sum``: under a
data-parallel train step each rank's term is its numerator over the global
batch's denominator (the ranks' terms sum to the global loss, as in JAX's
sharded step); outside one it is the plain sum.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vlsat_tpu_torch.ops.graph import gather_edge_endpoints
from vlsat_tpu_torch.ops.norm import safe_normalize
from vlsat_tpu_torch.parallel.mesh import global_sum
from vlsat_tpu_torch.scene import SceneBatch

Aux = Dict[str, torch.Tensor]


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the entries where ``mask`` (broadcast over x's
    trailing axes) is set; the count is of broadcast elements over the
    global batch, at least 1."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    denom = global_sum((m * torch.ones_like(x)).sum()).clamp(min=1.0)
    return (x * m).sum() / denom


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return masked_mean(nll, mask)


def dynamic_rel_weights(gt_rels: torch.Tensor, edge_mask: torch.Tensor,
                        ignore_none_rel: bool = False,
                        none_ratio: Optional[float] = 1.0) -> torch.Tensor:
    """Per-class BCE weights from the batch's label counts (WEIGHT_EDGE =
    DYNAMIC, losses.py:43-67): a leading "none" slot counts valid edges with
    no relation; w = 1 / (log(count + 1) + 1); the none slot is dropped after
    filling zero weights with it."""
    m = edge_mask.to(gt_rels.dtype)
    per_class = (gt_rels * m[..., None]).sum(dim=tuple(range(gt_rels.dim() - 1)))
    zeros = ((gt_rels.sum(-1) == 0) * m).sum()[None]
    counts = global_sum(torch.cat([zeros, per_class]))
    weight = torch.abs(1.0 / (torch.log(counts + 1.0) + 1.0))
    if ignore_none_rel:
        weight = torch.cat([weight.new_zeros(1), weight[1:]]) * 1e-2
    if none_ratio is not None and none_ratio != 1.0:
        weight = torch.cat([weight[:1] * none_ratio, weight[1:]])
    fill = weight[0] if not ignore_none_rel else weight.new_zeros(())
    weight = torch.where(weight == 0, fill, weight)
    return weight[1:]


def weighted_bce(probs: torch.Tensor, targets: torch.Tensor,
                 weight: Optional[torch.Tensor], edge_mask: torch.Tensor,
                 eps: float = 1e-7) -> torch.Tensor:
    """Binary cross-entropy of sigmoid outputs over valid edges, per-class
    (or per-element) weighted."""
    p = probs.clamp(eps, 1.0 - eps)
    ll = -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
    if weight is not None:
        ll = ll * weight
    return masked_mean(ll, edge_mask)


def single_label_rel_weights(gt_rels_onehot: torch.Tensor, edge_mask: torch.Tensor,
                             ignore_none_rel: bool = False) -> torch.Tensor:
    """DYNAMIC weights of the single-label mode (losses.py:82-91): per-class
    counts of the one-hot targets (class 0 = none), w = 1/(log(c+1)+1)."""
    m = edge_mask.to(gt_rels_onehot.dtype)
    counts = global_sum(
        (gt_rels_onehot * m[..., None]).sum(dim=tuple(range(gt_rels_onehot.dim() - 1))))
    weight = torch.abs(1.0 / (torch.log(counts + 1.0) + 1.0))
    if ignore_none_rel:
        weight = torch.cat([weight.new_zeros(1), weight[1:]]) * 1e-2
    return weight


def single_label_rel_nll(log_probs: torch.Tensor, gt_rels_onehot: torch.Tensor,
                         weight: Optional[torch.Tensor],
                         edge_mask: torch.Tensor) -> torch.Tensor:
    """Weighted NLL over valid edges with torch's ``nll_loss`` reduction:
    sum(w_y * nll) / sum(w_y)."""
    nll = -(gt_rels_onehot * log_probs).sum(-1)
    m = edge_mask.to(log_probs.dtype)
    if weight is not None:
        w_y = (gt_rels_onehot * weight).sum(-1)
        return (nll * w_y * m).sum() / global_sum((w_y * m).sum()).clamp(min=1e-12)
    return (nll * m).sum() / global_sum(m.sum()).clamp(min=1.0)


def triplet_distill_loss(obj_logits_3d: torch.Tensor, rel_cls_3d: torch.Tensor,
                         obj_logits_2d: torch.Tensor, rel_cls_2d: torch.Tensor,
                         edge_index: torch.Tensor, edge_mask: torch.Tensor,
                         chunk: int = 64) -> torch.Tensor:
    """3D-vs-2D triplet score-cube L1 (losses.py:106-136; unused by the
    shipped training, kept for ablations).  Each edge's (C*C, R) block is
    materialised, ``chunk`` edges at a time; the 2D side is detached."""
    s3 = torch.softmax(obj_logits_3d, dim=-1)
    s2 = torch.softmax(obj_logits_2d, dim=-1).detach()
    s3_i, s3_j = (t.flatten(0, 1) for t in gather_edge_endpoints(s3, edge_index))
    s2_i, s2_j = (t.flatten(0, 1) for t in gather_edge_endpoints(s2, edge_index))
    r3 = rel_cls_3d.flatten(0, 1)
    r2 = rel_cls_2d.detach().flatten(0, 1)
    m = edge_mask.flatten().to(r3.dtype)
    total = r3.new_zeros(())
    for lo in range(0, r3.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        ns3 = (s3_i[sl, :, None] * s3_j[sl, None, :]).flatten(1)
        ns2 = (s2_i[sl, :, None] * s2_j[sl, None, :]).flatten(1)
        diff = (ns3[:, :, None] * r3[sl, None, :] - ns2[:, :, None] * r2[sl, None, :]).abs()
        total = total + (diff.sum(dim=(1, 2)) * m[sl]).sum()
    return total / global_sum(edge_mask.sum()).clamp(min=1)


def resolve_rel_weights(mode: str, gt_rels: torch.Tensor, edge_mask: torch.Tensor,
                        multi_rel: bool = True, w_bg: float = 1.0,
                        none_ratio: float = 1.0, ignore_none_rel: bool = False,
                        weights_rel: Optional[torch.Tensor] = None):
    """WEIGHT_EDGE dispatch (losses.py:139-166): DYNAMIC per-batch counts,
    BG foreground/background mix, OCCU dataset occurrence weights, NONE."""
    if mode == "DYNAMIC":
        if multi_rel:
            return dynamic_rel_weights(gt_rels, edge_mask, ignore_none_rel=ignore_none_rel,
                                       none_ratio=none_ratio)
        return single_label_rel_weights(gt_rels, edge_mask, ignore_none_rel=ignore_none_rel)
    if mode == "BG":
        if not multi_rel:
            raise NotImplementedError("BG weighting is multi-label only")
        return w_bg * (1.0 - gt_rels) + (1.0 - w_bg) * gt_rels if w_bg != 0 else None
    if mode == "OCCU":
        return weights_rel
    if mode == "NONE":
        return None
    raise NotImplementedError(f"unknown WEIGHT_EDGE {mode!r}")


def cosine_mimic_loss(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                      t: float = 0.8) -> torch.Tensor:
    """mean over valid rows of max(t - cos(a, b), 0)."""
    cos = (safe_normalize(a) * safe_normalize(b)).sum(-1)
    return masked_mean(torch.clamp(t - cos, min=0.0), mask)


def rel_mimic_l1(edge_feature_2d: torch.Tensor, rel_text_feat: torch.Tensor,
                 edge_mask: torch.Tensor) -> torch.Tensor:
    """L1 between the normalised projected pair features and the text
    targets, over valid edges."""
    return masked_mean(torch.abs(safe_normalize(edge_feature_2d) - rel_text_feat), edge_mask)


def _rel_loss(probs, batch, w, multi_rel):
    if multi_rel:
        return weighted_bce(probs, batch.gt_rels, w, batch.edge_mask)
    # single-label mode: the heads emit log-probs over [none] + classes
    return single_label_rel_nll(probs, batch.gt_rels, w, batch.edge_mask)


def _normalised_lambdas(lambda_o: float) -> Tuple[float, float]:
    lam = max(1.0, lambda_o)
    return 1.0 / lam, lambda_o / lam


def vlsat_total_loss(outputs: Dict[str, torch.Tensor], batch: SceneBatch,
                     lambda_o: float = 0.1, ignore_none_rel: bool = False,
                     none_ratio: float = 1.0, multi_rel: bool = True,
                     weight_mode: str = "DYNAMIC", w_bg: float = 1.0,
                     weights_rel: Optional[torch.Tensor] = None,
                     with_mimic: bool = True) -> Tuple[torch.Tensor, Aux]:
    """The flagship objective (losses.py:186-244).  ``with_mimic=False`` is
    the in21k protocol: lambda_o*(obj2d+obj3d) + 3*(rel2d+rel3d)."""
    lambda_r, lambda_o = _normalised_lambdas(lambda_o)
    loss_obj_3d = cross_entropy(outputs["obj_logits_3d"], batch.gt_class, batch.obj_mask)
    loss_obj_2d = cross_entropy(outputs["obj_logits_2d"], batch.gt_class, batch.obj_mask)
    w = resolve_rel_weights(weight_mode, batch.gt_rels, batch.edge_mask, multi_rel=multi_rel,
                            w_bg=w_bg, none_ratio=none_ratio,
                            ignore_none_rel=ignore_none_rel, weights_rel=weights_rel)
    loss_rel_3d = _rel_loss(outputs["rel_cls_3d"], batch, w, multi_rel)
    loss_rel_2d = _rel_loss(outputs["rel_cls_2d"], batch, w, multi_rel)

    zero = loss_obj_3d.new_zeros(())
    loss_mimic, loss_rel_mimic = zero, zero
    if with_mimic:
        loss_mimic = cosine_mimic_loss(outputs["obj_feature_3d_mimic"],
                                       outputs["obj_features_2d_mimic"], batch.obj_mask)
        if batch.rel_text_feat is not None:
            loss_rel_mimic = rel_mimic_l1(outputs["edge_feature_2d_dis"], batch.rel_text_feat,
                                          batch.edge_mask)
    total = (lambda_o * (loss_obj_2d + loss_obj_3d)
             + 3.0 * lambda_r * (loss_rel_2d + loss_rel_3d)
             + 0.1 * (loss_mimic + loss_rel_mimic))
    aux = dict(loss=total, obj_loss=loss_obj_3d, obj_loss_2d=loss_obj_2d,
               rel_loss=loss_rel_3d, rel_loss_2d=loss_rel_2d,
               mimic_loss=loss_mimic, rel_mimic_loss_2d=loss_rel_mimic)
    return total, aux


def vlsat_single_loss(outputs: Dict[str, torch.Tensor], batch: SceneBatch,
                      lambda_o: float = 0.1, ignore_none_rel: bool = False,
                      none_ratio: float = 1.0, weight_mode: str = "DYNAMIC",
                      w_bg: float = 1.0, weights_rel: Optional[torch.Tensor] = None,
                      multi_rel: bool = True) -> Tuple[torch.Tensor, Aux]:
    """3D-only variant: lambda_o*obj + 3*rel + 0.1*rel_mimic_3d
    (losses.py:247-274)."""
    lambda_r, lambda_o = _normalised_lambdas(lambda_o)
    loss_obj = cross_entropy(outputs["obj_logits_3d"], batch.gt_class, batch.obj_mask)
    w = resolve_rel_weights(weight_mode, batch.gt_rels, batch.edge_mask, multi_rel=multi_rel,
                            w_bg=w_bg, none_ratio=none_ratio,
                            ignore_none_rel=ignore_none_rel, weights_rel=weights_rel)
    loss_rel = _rel_loss(outputs["rel_cls_3d"], batch, w, multi_rel)
    if batch.rel_text_feat is not None:
        mimic = rel_mimic_l1(outputs["edge_feature_3d_dis"], batch.rel_text_feat,
                             batch.edge_mask)
    else:
        mimic = loss_obj.new_zeros(())
    total = lambda_o * loss_obj + 3.0 * lambda_r * loss_rel + 0.1 * mimic
    return total, dict(loss=total, obj_loss=loss_obj, rel_loss=loss_rel,
                       rel_mimic_loss_3d=mimic)


def _nll_obj(outputs, batch):
    logp = outputs["obj_logits_3d"]
    nll = -torch.gather(logp, -1, batch.gt_class.long()[..., None])[..., 0]
    return masked_mean(nll, batch.obj_mask)


def sgfn_loss(outputs: Dict[str, torch.Tensor], batch: SceneBatch, lambda_o: float = 0.1,
              weight_mode: str = "DYNAMIC", w_bg: float = 1.0, none_ratio: float = 1.0,
              weights_rel: Optional[torch.Tensor] = None,
              multi_rel: bool = True) -> Tuple[torch.Tensor, Aux]:
    """SGFN baseline: lambda_o*obj + lambda_r*rel (losses.py:277-299); the
    object head emits log-probs, so the object term is their NLL."""
    lambda_r, lambda_o = _normalised_lambdas(lambda_o)
    loss_obj = _nll_obj(outputs, batch)
    w = resolve_rel_weights(weight_mode, batch.gt_rels, batch.edge_mask, multi_rel=multi_rel,
                            w_bg=w_bg, none_ratio=none_ratio, weights_rel=weights_rel)
    loss_rel = _rel_loss(outputs["rel_cls_3d"], batch, w, multi_rel)
    total = lambda_o * loss_obj + lambda_r * loss_rel
    return total, dict(loss=total, obj_loss=loss_obj, rel_loss=loss_rel)


def sgpn_loss(outputs: Dict[str, torch.Tensor],
              batch: SceneBatch) -> Tuple[torch.Tensor, Aux]:
    """SGPN baseline: 0.1*nll_obj + unweighted bce_rel (losses.py:302-312)."""
    loss_obj = _nll_obj(outputs, batch)
    loss_rel = weighted_bce(outputs["rel_cls_3d"], batch.gt_rels, None, batch.edge_mask)
    total = 0.1 * loss_obj + loss_rel
    return total, dict(loss=total, obj_loss=loss_obj, rel_loss=loss_rel)
