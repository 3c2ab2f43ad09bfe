"""Plain evaluation metrics with the original reference's rank semantics
(eva_utils_acc.py: object, predicate and triplet Acc@k, per-class mean
predicate accuracy and triplet mean recall), edge by edge over unpadded
scenes.

* Object rank: 1 + the classes whose logit is strictly above the ground
  truth's, capped at 12.
* Predicate ranks (multi-label sigmoid scores): per ground-truth predicate,
  1 + the classes scored strictly above it, capped at 7; several on one edge
  are sorted and discounted (rank i minus i); an edge with none ranks at 1 +
  the classes scored at or above 0.5, or 7 when all are.
* Triplet ranks: over the full (subject class, object class, predicate)
  cube of ``(s_a * o_b) * r_l`` in fp32, with s, o the softmax of the
  object logits: 1 + the cells strictly above the ground truth's own cell,
  capped at 102 (an edge with none: the cells above 0.5); discounted as the
  predicate ranks.

Imports torch and numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

OBJ_TOPK, PRED_TOPK, TRIP_TOPK = 11, 6, 101
FAMILIES = (("obj_acc", "obj", (1, 5, 10)), ("rel_acc", "rel", (1, 3, 5)),
            ("triplet_acc", "trip", (50, 100)))


def _discount(ranks: List[int]) -> List[int]:
    return [r - i for i, r in enumerate(sorted(ranks))]


def _capped(count: int, topk: int) -> int:
    return count + 1 if count < topk else topk + 1


def scene_ranks(obj_logits: torch.Tensor, rel_probs: torch.Tensor, gt_class: torch.Tensor,
                gt_rels: torch.Tensor, edge_index: torch.Tensor, block: int = 128) -> dict:
    """Ranks of one branch over a block of scenes (concatenated, edges with
    global node indices): ``obj`` per node, ``rel`` and ``trip`` flat in
    edge order and ground-truth slot order, ``preds`` the predicate (-1 for
    an edge without one) of each flat slot."""
    logits = obj_logits.float()
    gt_score = logits.gather(1, gt_class[:, None])
    obj = torch.clamp((logits > gt_score).sum(1) + 1, max=OBJ_TOPK + 1).cpu().numpy()
    probs = torch.softmax(logits, dim=-1)
    r = rel_probs.float()
    gt = gt_rels > 0
    sub, ob = edge_index[:, 0], edge_index[:, 1]
    pred_counts = (r[:, None, :] > r[:, :, None]).sum(-1)          # (E, R): above class k
    above_half = (r >= 0.5).sum(-1)
    # triplet counts, for every ground-truth cell and the 0.5 threshold
    thr_cols = int(gt.sum(-1).max().item()) if gt.numel() else 0
    trip_counts = torch.zeros(len(r), thr_cols + 1, dtype=torch.long, device=r.device)
    gt_cls_ids = torch.where(gt, torch.arange(r.shape[1], device=r.device), r.shape[1])
    gt_cls_ids = torch.sort(gt_cls_ids, dim=1).values[:, :thr_cols]  # ascending ids, pad R
    p_gt = probs.gather(1, gt_class[:, None])[:, 0]
    for lo in range(0, len(r), block):
        sl = slice(lo, lo + block)
        s, o, rr = probs[sub[sl]], probs[ob[sl]], r[sl]
        cube = (s[:, :, None] * o[:, None, :])[..., None] * rr[:, None, None, :]
        cube = cube.flatten(1)
        st = (p_gt[sub[sl]] * p_gt[ob[sl]])[:, None]
        ids = gt_cls_ids[sl]
        r_pad = torch.cat([rr, rr.new_zeros(len(rr), 1)], 1)
        thr = st * r_pad.gather(1, ids)                                # (e, thr_cols)
        for k in range(thr_cols):
            trip_counts[sl, k] = (cube > thr[:, k:k + 1]).sum(1)
        trip_counts[sl, -1] = (cube > 0.5).sum(1)
    pred_counts, above_half = pred_counts.cpu().numpy(), above_half.cpu().numpy()
    trip_counts, gt_np = trip_counts.cpu().numpy(), gt.cpu().numpy()
    ids_np = gt_cls_ids.cpu().numpy()
    nrel = r.shape[1]
    rel, trip, preds = [], [], []
    for e in range(len(gt_np)):
        ks = [int(k) for k in ids_np[e] if k < nrel]
        if not ks:
            rel.append(int(above_half[e]) + 1 if above_half[e] < nrel else PRED_TOPK + 1)
            trip.append(_capped(int(trip_counts[e, -1]), TRIP_TOPK))
            preds.append(-1)
            continue
        rel.extend(_discount([min(int(pred_counts[e, k]) + 1, PRED_TOPK + 1) for k in ks]))
        trip.extend(_discount([_capped(int(trip_counts[e, i]), TRIP_TOPK)
                               for i in range(len(ks))]))
        preds.extend(ks)
    return {"obj": obj, "rel": np.asarray(rel), "trip": np.asarray(trip),
            "preds": np.asarray(preds)}


def topk_accuracy(ranks: np.ndarray, k: int) -> float:
    return float((ranks <= k).sum() * 100.0 / len(ranks)) if len(ranks) else 0.0


def class_mean(ranks: np.ndarray, preds: np.ndarray, k: int, num_rel: int,
               as_f32: bool = False) -> float:
    """Mean over the predicate classes present of Acc@k (percent); with
    ``as_f32`` the per-class percentages are rounded to float32 before the
    mean, as the original reference's mean recall keeps them."""
    keep = (preds >= 0) & (preds < num_rel)
    pc, r = preds[keep], ranks[keep]
    tot = np.array([(pc == c).sum() for c in range(num_rel)], np.float64)
    hits = np.array([((pc == c) & (r <= k)).sum() for c in range(num_rel)], np.float64)
    nz = tot > 0
    if not nz.any():
        return 0.0
    if as_f32:
        return float((hits[nz] * 100.0 / tot[nz]).astype(np.float32).mean())
    return float((hits[nz] / tot[nz]).mean() * 100.0)


def metrics(parts: Sequence[Dict[str, dict]], num_rel: int = 26) -> Dict[str, float]:
    """The metric dict over blocks of ``{"3d": ranks, "2d": ranks}``
    (``scene_ranks``), with the names of the program's ``evaluate``."""
    out: Dict[str, float] = {}
    tags = [t for t in ("3d", "2d") if t in parts[0]]
    for tag in tags:
        cat = {k: np.concatenate([p[tag][k] for p in parts])
               for k in ("obj", "rel", "trip", "preds")}
        suffix = "" if tag == "3d" else "_2d"
        for name, key, ks in FAMILIES:
            for k in ks:
                out[f"{name}{suffix}_{k}"] = topk_accuracy(cat[key], k)
        mid = "" if tag == "3d" else "_2d"
        for k in (1, 3, 5):
            out[f"rel_acc{mid}_mean_{k}"] = class_mean(cat["rel"], cat["preds"], k, num_rel)
        recall = "mean_recall" if tag == "3d" else "mean_recall_2d"
        for k in (50, 100):
            out[f"{recall}_{k}"] = class_mean(cat["trip"], cat["preds"], k, num_rel,
                                              as_f32=True)
    return out
