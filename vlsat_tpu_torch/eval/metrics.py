"""Evaluation metrics with the reference's rank semantics (counterpart of
``vlsat_tpu/eval/metrics.py``).

Device functions (``object_ranks`` :51, ``predicate_rank_parts`` :60,
``triplet_rank_parts`` :73, ``discounted_ranks_device`` :200,
``sorted_gt_preds_device`` :225) are plain torch on whatever device their
inputs are on; every rank is a count of strict f32 comparisons, so ranks
are exact.  Gathers are index gathers (the JAX package's one-hot matmul
gather is a TPU workaround; at HIGHEST precision it returns the same
values).  ``triplet_rank_parts`` is a softmax followed by
:func:`triplet_rank_parts_from_probs`, so a test can feed both packages the
same probabilities.

The host functions (:242-493) are numpy copies.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlsat_tpu_torch.ops.graph import gather_edge_endpoints


# --------------------------------------------------------------------------
# device-side rank counts
# --------------------------------------------------------------------------

def object_ranks(obj_logits: torch.Tensor, gt_class: torch.Tensor, topk: int = 11
                 ) -> torch.Tensor:
    """(..., C) logits + (...) labels -> (...) int32 ranks in [1, topk+1]:
    #{c : logit_c > logit_gt} + 1, capped."""
    logits = obj_logits.float()
    gt_score = torch.gather(logits, -1, gt_class.long()[..., None])
    greater = (logits > gt_score).sum(-1)
    return torch.clamp(greater + 1, max=topk + 1).to(torch.int32)


def predicate_rank_parts(rel_probs: torch.Tensor, topk: int = 6, threshold: float = 0.5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class ranks (..., R) and the no-GT threshold rank (...)."""
    p = rel_probs.float()
    greater = (p[..., None, :] > p[..., :, None]).sum(-1)
    class_ranks = torch.clamp(greater + 1, max=topk + 1).to(torch.int32)
    above = (p >= threshold).sum(-1)
    no_gt = torch.where(above < p.shape[-1], above + 1, topk + 1).to(torch.int32)
    return class_ranks, no_gt


@functools.lru_cache(maxsize=None)
def _staircase(k_node: int, topk: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Positions (a, b) of DESCENDING-sorted node scores with
    (a+1)(b+1) <= topk, as indices into the ASCENDING sort, on ``device``
    (built once: a host-to-device copy per call would stall the host), and
    the pair top-k width."""
    aa, bb = np.meshgrid(np.arange(k_node), np.arange(k_node), indexing="ij")
    keep = (aa + 1) * (bb + 1) <= topk
    idx = lambda a: torch.from_numpy(k_node - 1 - a[keep]).to(device)
    return idx(aa), idx(bb), min(topk, int(keep.sum()))


def triplet_rank_parts(obj_logits: torch.Tensor, gt_class: torch.Tensor,
                       rel_probs: torch.Tensor, edge_index: torch.Tensor,
                       topk: int = 101, threshold: float = 0.5, chunk: int = 128,
                       method: str = "topk") -> Tuple[torch.Tensor, torch.Tensor]:
    """Triplet ranks for every candidate predicate of every edge:
    (class_ranks (..., E, R), no_gt_ranks (..., E)).  Object scores are
    softmax(logits) (the reference's use_clip=True path).  Inputs are one
    scene ((N, C), (N,), (E, R), (E, 2)) or a batch of them."""
    probs = torch.softmax(obj_logits.float(), dim=-1)
    return triplet_rank_parts_from_probs(probs, gt_class, rel_probs, edge_index,
                                         topk=topk, threshold=threshold, chunk=chunk,
                                         method=method)


def triplet_rank_parts_from_probs(probs: torch.Tensor, gt_class: torch.Tensor,
                                  rel_probs: torch.Tensor, edge_index: torch.Tensor,
                                  topk: int = 101, threshold: float = 0.5,
                                  chunk: int = 128, method: str = "topk"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The core of :func:`triplet_rank_parts` on object probabilities.

    The rank of GT predicate k on edge (i, j) is 1 + #{cube cells
    s_a*o_b*r_l > (s_gt*o_gt)*r_k}, saturated at topk+1.

    ``method="topk"``: since the rank saturates, only the top-``topk``
    pair products can count; they come from per-node top-``topk`` scores
    on the static staircase (a+1)(b+1) <= topk, then one sort.  Candidates
    ``tpair*r`` and thresholds ``(s_gt*o_gt)*r_k`` are the same f32
    products as the reference cube's, so ties are exact.  The JAX package
    counts ``cand > threshold`` over a (chunk, R+1, topk, R) compare, which
    XLA fuses into its reduction; eagerly that tensor would be written,
    widened and reduced, so the candidates are sorted once per edge and
    each count is their number minus a right-sided ``searchsorted`` (the
    number of candidates <= the threshold): the same integers.
    ``method="sort"`` is the legacy searchsorted over the sorted (C*C) pair
    table, with the GT cell's division-ulp correction.

    Edges go in chunks of ``chunk`` (across the whole batch at once), which
    bounds the temporaries; chunking changes memory, not results."""
    single = probs.dim() == 2
    if single:
        probs, gt_class = probs[None], gt_class[None]
        rel_probs, edge_index = rel_probs[None], edge_index[None]
    probs = probs.float()
    r_all = rel_probs.float()
    ei_all = edge_index.long()
    c = probs.shape[-1]
    p_gt = torch.gather(probs, -1, gt_class.long()[..., None])[..., 0]     # (B, N)
    if method == "topk":
        k_node = min(c, topk)
        a_idx, b_idx, k_pair = _staircase(k_node, topk, probs.device)
        node_top = torch.sort(probs, dim=-1).values[..., -k_node:]         # ascending
    elif method != "sort":
        raise ValueError(f"unknown method {method!r}")
    thr_col = torch.full((1,), threshold, dtype=torch.float32, device=probs.device)

    class_out, no_gt_out = [], []
    for lo in range(0, r_all.shape[1], chunk):
        r = r_all[:, lo:lo + chunk]                                         # (B, e, R)
        ei = ei_all[:, lo:lo + chunk]
        s_gt = torch.gather(p_gt, 1, ei[..., 0])
        o_gt = torch.gather(p_gt, 1, ei[..., 1])
        t_class = (s_gt * o_gt)[..., None] * r                              # (B, e, R)
        thresholds = torch.cat([t_class, thr_col.expand(*t_class.shape[:-1], 1)], -1)
        if method == "topk":
            st, ot = gather_edge_endpoints(node_top, ei)                    # (B, e, k_node)
            stair = st[..., a_idx] * ot[..., b_idx]
            tpair = torch.sort(stair, dim=-1).values[..., -k_pair:]
            cand = (tpair[..., :, None] * r[..., None, :]).flatten(-2)      # (B, e, kp*R)
            cand = torch.sort(cand, dim=-1).values
            counts = cand.shape[-1] - torch.searchsorted(cand, thresholds, right=True)
            class_counts = counts[..., :-1]
        else:
            sub, obj = gather_edge_endpoints(probs, ei)                     # (B, e, C)
            r_safe = torch.clamp(r, min=1e-38)
            ratio = thresholds[..., :, None] / r_safe[..., None, :]          # (B, e, R+1, R)
            ns = (sub[..., :, None] * obj[..., None, :]).flatten(-2)
            ns_sorted = torch.sort(ns, dim=-1).values
            pos = torch.searchsorted(ns_sorted, ratio.flatten(-2), right=True)
            counts = (c * c - pos).view(ratio.shape).sum(-1)
            div_gt = (s_gt * o_gt)[..., None] > t_class / r_safe
            class_counts = counts[..., :-1] - div_gt.long()
        c05 = counts[..., -1]
        class_out.append(torch.where(class_counts < topk, class_counts + 1, topk + 1))
        no_gt_out.append(torch.where(c05 < topk, c05 + 1, topk + 1))
    if class_out:
        cr = torch.cat(class_out, 1).to(torch.int32)
        ng = torch.cat(no_gt_out, 1).to(torch.int32)
    else:
        cr = torch.zeros(r_all.shape, dtype=torch.int32, device=probs.device)
        ng = torch.zeros(r_all.shape[:-1], dtype=torch.int32, device=probs.device)
    return (cr[0], ng[0]) if single else (cr, ng)


# --------------------------------------------------------------------------
# device-side discounting
# --------------------------------------------------------------------------

def discounted_ranks_device(class_ranks: torch.Tensor, no_gt_ranks: torch.Tensor,
                            gt_rels: torch.Tensor) -> torch.Tensor:
    """Per edge, the GT ranks sorted ascending minus their position index
    (the reference's ``tmp - counter``), no-GT edges carrying their
    threshold rank in slot 0.  Returns (..., R) int32 values OFFSET BY R-1
    and clipped to [0, 255] (uint8-safe); slots past each edge's
    max(#GT, 1) are meaningless and are masked on the host."""
    nrel = gt_rels.shape[-1]
    gt = gt_rels > 0
    cnt = gt.sum(-1)
    ranks = torch.where(gt, class_ranks.to(torch.int32), 1 << 20)
    disc = torch.sort(ranks, dim=-1).values - torch.arange(
        nrel, dtype=torch.int32, device=ranks.device)
    vals = torch.where((cnt == 0)[..., None], no_gt_ranks.to(torch.int32)[..., None], disc)
    return torch.clamp(vals + (nrel - 1), 0, 255)


def sorted_gt_preds_device(gt_rels: torch.Tensor) -> torch.Tensor:
    """Per-edge GT predicate ids ascending, encoded as id+1 with 0 = the
    no-GT edge marker and R+1 padding past each edge's GT count."""
    nrel = gt_rels.shape[-1]
    gt = gt_rels > 0
    cnt = gt.sum(-1)
    pm = torch.where(gt, torch.arange(nrel, dtype=torch.int32, device=gt.device), nrel)
    spm = torch.sort(pm, dim=-1).values + 1
    return torch.where((cnt == 0)[..., None], 0, spm)


# --------------------------------------------------------------------------
# host-side assembly (numpy copies of vlsat_tpu/eval/metrics.py:242-329)
# --------------------------------------------------------------------------

def _discount_parts(class_ranks: np.ndarray, no_gt_ranks: np.ndarray, gt_rels: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(per-edge padded value matrix (E, R), validity mask (E, R) of each
    edge's first max(#GT, 1) slots, GT counts (E,)); ``vals[valid]`` is the
    reference's edge-major accumulation order."""
    e, r = gt_rels.shape
    gt = gt_rels > 0
    cnt = gt.sum(axis=1)
    big = np.iinfo(np.int64).max
    ranks = np.where(gt, class_ranks.astype(np.int64), big)
    disc = np.sort(ranks, axis=1) - np.arange(r, dtype=np.int64)[None, :]
    vals = np.where((cnt == 0)[:, None], no_gt_ranks.astype(np.int64)[:, None], disc)
    valid = np.arange(r)[None, :] < np.maximum(cnt, 1)[:, None]
    return vals, valid, cnt


def assemble_predicate_topk(class_ranks: np.ndarray, no_gt_ranks: np.ndarray,
                            gt_rels: np.ndarray) -> np.ndarray:
    """Flat per-edge rank list with multi-GT discounting (valid edges)."""
    if gt_rels.shape[0] == 0:
        return np.zeros((0,), np.int64)
    vals, valid, _ = _discount_parts(class_ranks, no_gt_ranks, gt_rels)
    return vals[valid]


def assemble_triplet_topk(class_ranks: np.ndarray, no_gt_ranks: np.ndarray,
                          gt_rels: np.ndarray, sub_cls: np.ndarray, obj_cls: np.ndarray,
                          obj_rank_sub: np.ndarray, obj_rank_obj: np.ndarray,
                          sub_scores: Optional[np.ndarray] = None,
                          obj_scores: Optional[np.ndarray] = None,
                          rel_scores: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Triplet ranks + cls_matrix rows [sub_gt, sub_rank, obj_gt, obj_rank,
    predicate] (predicate -1 for no-GT edges), + score lists."""
    e, r = gt_rels.shape
    if e == 0:
        z = np.zeros((0,), np.int64)
        out = {"topk": z, "cls_matrix": np.zeros((0, 5), np.int64)}
        if sub_scores is not None:
            out["sub_scores"] = np.zeros((0, sub_scores.shape[-1]), np.float32)
            out["obj_scores"] = np.zeros((0, obj_scores.shape[-1]), np.float32)
            out["rel_scores"] = np.zeros((0, rel_scores.shape[-1]), np.float32)
        return out
    vals, valid, cnt = _discount_parts(class_ranks, no_gt_ranks, gt_rels)
    counts = np.maximum(cnt, 1)
    big = np.iinfo(np.int64).max
    pm = np.where(gt_rels > 0, np.arange(r, dtype=np.int64)[None, :], big)
    preds = np.where((cnt == 0)[:, None], -1, np.sort(pm, axis=1))[valid]
    rep = lambda a: np.repeat(np.asarray(a).astype(np.int64), counts)
    out = {
        "topk": vals[valid],
        "cls_matrix": np.stack(
            [rep(sub_cls), rep(obj_rank_sub), rep(obj_cls), rep(obj_rank_obj), preds],
            axis=1),
    }
    if sub_scores is not None:
        keep = preds >= 0
        out["sub_scores"] = np.repeat(sub_scores, counts, axis=0)[keep]
        out["obj_scores"] = np.repeat(obj_scores, counts, axis=0)[keep]
        out["rel_scores"] = np.repeat(rel_scores, counts, axis=0)[keep]
    return out


# --------------------------------------------------------------------------
# aggregate metrics (numpy copies of vlsat_tpu/eval/metrics.py:336-493)
# --------------------------------------------------------------------------

def topk_accuracy(ranks: np.ndarray, k: int) -> float:
    if len(ranks) == 0:
        return 0.0
    return float((ranks <= k).sum() * 100.0 / len(ranks))


def evaluate_topk(objs_pred: np.ndarray, rels_pred: np.ndarray, gt_rel: Sequence,
                  edges: np.ndarray, multi_rel_outputs: bool, topk: int = 101
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge triplet rank over the full C*C*R score cube
    (``vlsat_tpu/eval/metrics.py:342-392``, the reference's
    eva_utils_acc.py:82-134, which no model or runner calls).

    ``objs_pred`` (N, C) log-softmax object scores, exponentiated;
    ``rels_pred`` (E, R) sigmoid probabilities (``multi_rel_outputs``) or
    log-softmax scores, exponentiated; ``gt_rel`` per edge (sub_cls,
    obj_cls, [predicate ids]).  The cube cell of edge (i, j) is
    ``(objs[i, a] * objs[j, b]) * rels[e, k]``; a GT predicate's rank is 1 +
    the cells strictly above its cell (ties count as hits), capped at
    ``topk + 1``; several GT predicates on one edge take the sorted
    discount ``sorted(ranks)[i] - i``.  Returns (ranks, predicate ids in
    edge order)."""
    objs = np.exp(np.asarray(objs_pred, np.float32))
    rels = np.asarray(rels_pred, np.float32)
    if not multi_rel_outputs:
        rels = np.exp(rels)
    edges = np.asarray(edges).reshape(-1, 2)
    res: List[int] = []
    cls: List[int] = []
    for e in range(len(edges)):
        preds = list(gt_rel[e][2])
        if not preds:
            continue
        s, o, r = objs[edges[e, 0]], objs[edges[e, 1]], rels[e]
        # (s_a * o_b) first, then * r_k: the GT cell ties with its own
        # threshold exactly and never counts as greater
        cube = np.multiply.outer(np.multiply.outer(s, o), r)
        ranks = sorted(
            min(int((cube > (s[gt_rel[e][0]] * o[gt_rel[e][1]]) * r[p]).sum()) + 1, topk + 1)
            for p in preds)
        res.extend(rank - i for i, rank in enumerate(ranks))
        cls.extend(preds)
    return np.asarray(res), np.asarray(cls)


def get_mean_recall(triplet_rank: np.ndarray, cls_matrix: np.ndarray,
                    topk: Sequence[int] = (50, 100), num_rel_classes: int = 26
                    ) -> np.ndarray:
    """Mean over predicate classes of triplet recall@k."""
    if len(cls_matrix) == 0:
        return np.zeros(len(topk))
    preds = np.asarray(cls_matrix[:, -1])
    m = (preds >= 0) & (preds < num_rel_classes)
    pc = preds[m].astype(np.int64)
    ranks = np.asarray(triplet_rank)[m]
    tot = np.bincount(pc, minlength=num_rel_classes)
    nz = tot > 0
    if not nz.any():
        return np.zeros(len(topk))
    out = []
    for k in topk:
        hits = np.bincount(pc, weights=(ranks <= k).astype(np.float64),
                           minlength=num_rel_classes)
        out.append((hits[nz] * 100.0 / tot[nz]).astype(np.float32).mean())
    return np.asarray(out)


def compute_mean_predicate(cls_matrix: np.ndarray, topk_pred: np.ndarray,
                           ks: Sequence[int] = (1, 3, 5), num_rel_classes: int = 26
                           ) -> List[float]:
    """Per-predicate-class mean Acc@k; the predicate rank list and the
    cls_matrix rows are index-aligned."""
    preds = np.asarray(cls_matrix[:, -1]) if len(cls_matrix) else np.zeros(0, np.int64)
    m = preds >= 0
    pc = preds[m].astype(np.int64)
    ranks = np.asarray(topk_pred)[m] if len(cls_matrix) else np.zeros(0, np.int64)
    tot = np.bincount(pc, minlength=num_rel_classes)
    nz = tot > 0
    means = []
    for k in ks:
        if not nz.any():
            means.append(0.0)
            continue
        hits = np.bincount(pc, weights=(ranks <= k).astype(np.float64),
                           minlength=num_rel_classes)
        means.append(float((hits[nz] / tot[nz]).mean() * 100.0))
    return means


def get_zero_shot_recall(triplet_rank: np.ndarray, cls_matrix: np.ndarray,
                         train_triplets: set) -> Dict[str, float]:
    """Zero-shot / non-zero-shot / all triplet recall@50/@100;
    ``train_triplets`` holds "<sub_cls> <obj_cls> <rel>" keys seen in
    training."""
    cm = np.asarray(cls_matrix)
    ranks = np.asarray(triplet_rank)
    m = cm[:, -1] != -1 if len(cm) else np.zeros(0, bool)
    cm = cm[m]
    all_r = ranks[m]
    if len(cm):
        base = int(max(cm[:, 0].max(), cm[:, 2].max(), cm[:, -1].max())) + 2
        enc = (cm[:, 0].astype(np.int64) * base + cm[:, 2]) * base + cm[:, -1]
        vocab = []
        for key in train_triplets:
            s, o, p = (int(x) for x in key.split())
            if s < base - 1 and o < base - 1 and p < base - 1:
                vocab.append((s * base + o) * base + p)
        seen = np.isin(enc, np.asarray(vocab, dtype=np.int64))
    else:
        seen = np.zeros(0, bool)
    zero = all_r[~seen]
    non_zero = all_r[seen]

    def rec(a):
        a = np.asarray(a)
        if len(a) == 0:
            return (float("nan"), float("nan"))
        return (float((a <= 50).mean() * 100), float((a <= 100).mean() * 100))

    z50, z100 = rec(zero)
    n50, n100 = rec(non_zero)
    a50, a100 = rec(all_r)
    return {
        "zero_shot_50": z50, "zero_shot_100": z100,
        "non_zero_shot_50": n50, "non_zero_shot_100": n100,
        "all_50": a50, "all_100": a100,
    }
