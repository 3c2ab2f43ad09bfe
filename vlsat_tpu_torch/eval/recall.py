"""Scene-level Recall@K / mean-Recall@K for the in21k ``SCENE_RECALL``
protocol (counterpart of ``vlsat_tpu/eval/recall.py``).

Per edge, the top ``topk_each`` triplet candidates of the C*C*R confidence
cube (or of the R predicate scores, "rels" mode) are merged into a
scene-global top-``kmax`` ranking; an edge with GT counts as recalled at K
if one of the first K candidates names its GT.  The device side
(``batched_scene_hits``) returns the ranked candidates' edges and hit flags;
the host side (``tally_hits_batch``, numpy) turns them into recalls.  The
per-scene API (``scene_recall_topk``, ``tally_ranked_candidates``,
``tally_hits``) ranks and tallies one scene on the host.

Ranking follows ``lax.top_k``: descending, ties to the lower index (a
stable descending sort), which for the flattened (edge, candidate) axis is
the reference's edge-major merge order.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from vlsat_tpu_torch.ops.graph import gather_edge_endpoints


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, descending, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def per_edge_topk(obj_logits: torch.Tensor, rel_probs: torch.Tensor,
                  edge_index: torch.Tensor, topk_each: int = 100
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scene: top-``topk_each`` (conf, flat idx) per edge from the
    (E, C*C) pair table; flat idx is the row-major (sub_cls, obj_cls, rel)
    index of the cube."""
    probs = torch.softmax(obj_logits.float(), dim=-1)
    r = rel_probs.float()
    nrel = r.shape[-1]
    ei = edge_index.long()
    sub, obj = probs[ei[:, 0]], probs[ei[:, 1]]
    ns = (sub[:, :, None] * obj[:, None, :]).flatten(1)                 # (E, C*C)
    ns_top, ns_idx = top_k(ns, min(topk_each, ns.shape[-1]))
    prod = (ns_top[:, :, None] * r[:, None, :]).flatten(1)
    conf, pidx = top_k(prod, min(topk_each, prod.shape[-1]))
    ns_sel = torch.gather(ns_idx, -1, pidx // nrel)
    return conf, ns_sel * nrel + pidx % nrel


@functools.lru_cache(maxsize=None)
def _staircase3(t: int, ka: int, kc: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Triples (a, b, c) of descending-sorted positions with
    (a+1)(b+1)(c+1) <= t (every deeper triple is dominated by >= t others),
    on ``device``, built once."""
    tr = [(a, b, c)
          for a in range(min(ka, t))
          for b in range(min(ka, t // (a + 1)))
          for c in range(min(kc, t // ((a + 1) * (b + 1))))]
    arr = torch.tensor(tr, dtype=torch.int64).to(device)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def _staircase_candidates(obj_logits: torch.Tensor, rel_probs: torch.Tensor,
                          edge_index: torch.Tensor, t: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge staircase candidates (conf, cube idx), each (B, E, S): a
    superset of every edge's top-``t`` triplets, with the confidences
    ``(s*o)*r`` of ``per_edge_topk`` bit for bit."""
    probs = torch.softmax(obj_logits.float(), dim=-1)
    r = rel_probs.float()
    c, nrel = probs.shape[-1], r.shape[-1]
    ka, kc = min(c, t), min(nrel, t)
    a_pos, b_pos, c_pos = _staircase3(t, ka, kc, probs.device)
    nv, ni = top_k(probs, ka)                                           # (B, N, ka)
    rv, ri = top_k(r, kc)                                               # (B, E, kc)
    sv, ov = gather_edge_endpoints(nv, edge_index)
    si, oi = gather_edge_endpoints(ni, edge_index)
    conf = (sv[..., a_pos] * ov[..., b_pos]) * rv[..., c_pos]
    cube = (si[..., a_pos] * c + oi[..., b_pos]) * nrel + ri[..., c_pos]
    return conf, cube


def batched_per_edge_topk(obj_logits: torch.Tensor, rel_probs: torch.Tensor,
                          edge_index: torch.Tensor, topk_each: int = 100
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``per_edge_topk`` for a batch, from the staircase candidates."""
    c, nrel = obj_logits.shape[-1], rel_probs.shape[-1]
    t = min(topk_each, c * c * nrel)
    conf_all, cube_all = _staircase_candidates(obj_logits, rel_probs, edge_index, t)
    conf, pos = top_k(conf_all, t)
    return conf, torch.gather(cube_all, -1, pos)


def batched_scene_hits(obj_logits: torch.Tensor, rel_probs: torch.Tensor,
                       edge_index: torch.Tensor, edge_mask: torch.Tensor,
                       gt_class: torch.Tensor, gt_rels: torch.Tensor,
                       topk_each: int = 100, kmax: int = 100, mode: str = "triplet",
                       method: str = "staircase") -> Tuple[torch.Tensor, torch.Tensor]:
    """Scene-global ranked candidates with their GT-hit flags for a batch:
    (edge ids (B, kmax) int32, hit (B, kmax) bool).  Padded edges rank last
    (confidence -1) and never hit; with fewer than ``kmax`` candidates the
    tail is (edge 0, no hit)."""
    c, nrel = obj_logits.shape[-1], rel_probs.shape[-1]
    if mode == "triplet" and method == "staircase":
        t = min(topk_each, c * c * nrel)
        if kmax <= topk_each or t == 1:
            # the per-edge cap cannot bind: merge the raw staircase sets
            conf, idx = _staircase_candidates(obj_logits, rel_probs, edge_index, t)
        else:
            conf, idx = batched_per_edge_topk(obj_logits, rel_probs, edge_index,
                                              topk_each=topk_each)
    elif mode == "triplet":
        pairs = [per_edge_topk(ol, r, ei, topk_each=topk_each)
                 for ol, r, ei in zip(obj_logits, rel_probs, edge_index)]
        conf = torch.stack([p[0] for p in pairs])
        idx = torch.stack([p[1] for p in pairs])
    elif mode == "rels":
        conf, idx = top_k(rel_probs.float(), min(topk_each, nrel))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    conf = torch.where(edge_mask[:, :, None], conf, -1.0)
    k = conf.shape[-1]
    _, pos = top_k(conf.flatten(1), min(kmax, conf.shape[-2] * k))
    edge_g = pos // k
    cand_g = torch.gather(idx.flatten(1), 1, pos)
    rows = gt_rels[torch.arange(gt_rels.shape[0], device=gt_rels.device)[:, None],
                   edge_g]                                              # (B, K, R)
    if mode == "rels":
        hit = torch.gather(rows, -1, cand_g[..., None])[..., 0] > 0
    else:
        i = cand_g // (c * nrel)
        j = (cand_g // nrel) % c
        rl = cand_g % nrel
        gc = gt_class.long()
        sub_cls = torch.gather(gc, 1, torch.gather(edge_index[..., 0].long(), 1, edge_g))
        obj_cls = torch.gather(gc, 1, torch.gather(edge_index[..., 1].long(), 1, edge_g))
        gt_hit = torch.gather(rows, -1, rl[..., None])[..., 0] > 0
        hit = (sub_cls == i) & (obj_cls == j) & gt_hit
    hit = hit & torch.gather(edge_mask, 1, edge_g)
    pad = kmax - edge_g.shape[-1]
    if pad > 0:
        edge_g = torch.nn.functional.pad(edge_g, (0, pad))
        hit = torch.nn.functional.pad(hit, (0, pad))
    return edge_g.to(torch.int32), hit


def tally_hits_batch(sel_edges: np.ndarray, hits: np.ndarray, gt_rels: np.ndarray,
                     edge_mask: np.ndarray, topk: Sequence[int], num_rel_classes: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host tally of a batch (vlsat_tpu/eval/recall.py:238-275 in numpy):
    (scalar (B, len(topk)), per-class (B, R, len(topk)) with -1 for absent
    classes, valid (B,) = scenes with >= 1 GT relation; invalid rows carry
    garbage).  An edge is recalled at K if its first hit ranks below K; the
    per-class variant credits every GT predicate of a recalled edge."""
    b, kmax = hits.shape
    e = gt_rels.shape[1]
    gt_pos = (gt_rels[..., :num_rel_classes] > 0) & edge_mask[..., None]
    totals = gt_pos.sum(axis=1).astype(np.float64)
    has_gt = (gt_rels > 0).any(axis=-1) & edge_mask
    total = has_gt.sum(axis=1).astype(np.float64)

    franks = np.full((b, e), kmax + 1, np.int64)
    si, ri = np.nonzero(hits)
    np.minimum.at(franks, (si, sel_edges[si, ri]), ri)

    ks = np.asarray(list(topk))
    rec = franks[:, :, None] < ks[None, None, :]
    scalar = rec.sum(axis=1) / np.maximum(total, 1.0)[:, None]
    # sum over edges as a batched matmul (numpy's einsum took ~1 ms a call
    # here); 0/1 products summed in f64 are exact either way
    correct = np.matmul(gt_pos.transpose(0, 2, 1).astype(np.float64), rec.astype(np.float64))
    out = np.full((b, num_rel_classes, len(ks)), -1.0)
    nz = totals > 0
    out[nz] = correct[nz] / totals[nz][:, None]
    return scalar, out, total > 0


# --------------------------------------------------------------------------
# the per-scene API (vlsat_tpu/eval/recall.py:278-421): one scene's ranked
# candidates tallied on the host; the engine uses the batched path above
# --------------------------------------------------------------------------

def tally_hits(sel_edges: np.ndarray, hits: np.ndarray, gt_rels: np.ndarray,
               topk: Sequence[int], num_rel_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tally one scene's ranked candidate list (the reference's
    eval_utils_recall.py:62-112): ``sel_edges`` (kmax,) candidate edge ids,
    ``hits`` (kmax,) whether each names its edge's GT, ``gt_rels`` (ev, R)
    the valid edges.  An edge with GT is recalled at K if one of the first K
    candidates hits it (its first hit decides); the per-class variant
    credits every GT predicate of a recalled edge.  Returns (scalar
    (len(topk),), per-class (num_rel_classes, len(topk)) with -1 for absent
    classes)."""
    gt_pos = gt_rels[:, :num_rel_classes] > 0
    totals = gt_pos.sum(axis=0).astype(np.float64)
    total = float((gt_rels > 0).any(axis=1).sum())
    first_rank_of = {}
    for r in np.nonzero(np.asarray(hits))[0]:
        first_rank_of.setdefault(int(sel_edges[r]), r)
    edges = np.asarray(sorted(first_rank_of), dtype=np.int64)
    franks = np.asarray([first_rank_of[int(e)] for e in edges], dtype=np.int64)
    scalar = np.zeros(len(topk))
    correct_cls = np.zeros((num_rel_classes, len(topk)))
    for t, k in enumerate(topk):
        rec = edges[franks < k]
        scalar[t] = len(rec)
        if len(rec):
            correct_cls[:gt_pos.shape[1], t] = gt_pos[rec].sum(axis=0)
    out = np.full((num_rel_classes, len(topk)), -1.0)
    nz = totals > 0
    out[nz] = correct_cls[nz] / totals[nz, None]
    return scalar / max(total, 1.0), out


def tally_ranked_candidates(sel_edges: np.ndarray, sel_idx: np.ndarray, gt_rels: np.ndarray,
                            sub_cls: np.ndarray, obj_cls: np.ndarray, *, topk: Sequence[int],
                            num_rel_classes: int, evaluate: str, c: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Hit flags of one scene's ranked candidates, then ``tally_hits``:
    "rels" needs the GT predicate, "triplet" the exact (sub_cls, obj_cls,
    predicate) of the cube index ``sel_idx``."""
    nrel = gt_rels.shape[-1]
    sel_edges, sel_idx = np.asarray(sel_edges), np.asarray(sel_idx)
    if evaluate == "rels":
        hits = gt_rels[sel_edges, sel_idx] > 0
    else:
        i, j, rl = sel_idx // (c * nrel), (sel_idx // nrel) % c, sel_idx % nrel
        hits = ((sub_cls[sel_edges] == i) & (obj_cls[sel_edges] == j)
                & (gt_rels[sel_edges, rl] > 0))
    return tally_hits(sel_edges, hits, gt_rels, topk=topk, num_rel_classes=num_rel_classes)


def scene_recall_topk(obj_logits: np.ndarray, rel_probs: np.ndarray, gt_rels: np.ndarray,
                      gt_class: np.ndarray, edge_index: np.ndarray,
                      topk: Sequence[int] = (20, 50, 100), topk_each: int = 100,
                      num_rel_classes: int = 26, per_class: bool = False,
                      evaluate: str = "triplet", valid_edges: "int | None" = None,
                      return_both: bool = False):
    """One scene's R@K (``per_class=True``: the per-class matrix;
    ``return_both``: both).  ``evaluate="triplet"`` (sgcls) ranks the
    sub * obj * predicate confidences and needs the exact GT triplet;
    "rels" (predcls) ranks the predicate scores and needs only the GT
    predicate.  ``topk_each=1`` is the graph-constrained variant, >= R the
    unconstrained one.  With padded inputs only the first ``valid_edges``
    edge rows are real: the candidates are computed at the padded shape and
    the padding is dropped on the host."""
    e_cnt, nrel = rel_probs.shape
    c = obj_logits.shape[-1]
    ev = e_cnt if valid_edges is None else int(valid_edges)
    if evaluate == "triplet":
        conf2, idx2 = per_edge_topk(torch.as_tensor(np.asarray(obj_logits)),
                                    torch.as_tensor(np.asarray(rel_probs)),
                                    torch.as_tensor(np.asarray(edge_index)),
                                    topk_each=topk_each)
        conf2, idx2 = conf2.numpy(), idx2.numpy().astype(np.int64)
    elif evaluate == "rels":
        idx2 = np.argsort(-rel_probs, axis=-1, kind="stable")[:, :min(topk_each, nrel)]
        idx2 = idx2.astype(np.int64)
        conf2 = np.take_along_axis(rel_probs, idx2, axis=-1)
    else:
        raise ValueError(f"unknown evaluate mode {evaluate!r}")
    k_per = conf2.shape[1]
    conf = conf2[:ev].reshape(-1)
    cube_idx = idx2[:ev].reshape(-1)
    edge_ids = np.repeat(np.arange(ev), k_per)
    order = np.argsort(-conf, kind="stable")[:int(max(topk))]
    scalar, out = tally_ranked_candidates(
        edge_ids[order], cube_idx[order], gt_rels[:ev], gt_class[edge_index[:, 0]],
        gt_class[edge_index[:, 1]], topk=topk, num_rel_classes=num_rel_classes,
        evaluate=evaluate, c=c)
    if return_both:
        return scalar, out
    return out if per_class else scalar
