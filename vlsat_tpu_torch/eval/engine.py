"""Validation engine: the full metric suite over a scene loader (counterpart
of ``vlsat_tpu/eval/engine.py:57-650``).

Per batch: one eval step, then every rank function (object / predicate /
triplet, 3D and 2D, the multi-GT discounting and, with ``scene_recall``, the
ranked scene-recall candidates and their hit flags) on the eval step's
device.  The rank tensors leave the device as ONE byte buffer, copied with
``non_blocking`` into pinned host memory and fenced by a CUDA event; the host
assembles batch k while the device runs batch k+1, in the loader's scene
order, which is the reference's accumulation order.

A loader yields host batches (streamed: wire-encoded, pinned and copied to
the device), ``(host, device)`` pairs (``data/resident.py``
``ResidentEvalLoader``: no per-batch copy) or, with ``loader.grouped``,
``(hosts, full, idx)`` groups (``ResidentGroupedEval``, the counterpart of
``_get_fused_grouped``, ``vlsat_tpu/eval/engine.py:218-255``): K
minibatches gathered on the device from a resident bucket run back to back
and their packed buffers leave in one (K, n) copy.

Under a data-parallel group (a loader with ``mesh_sharded``: the
``parallel.shard_eval_batches`` wrapper, ``data.resident.ResidentShardedEval``)
each rank runs the eval step on its block of every batch; the packed host
buffers are gathered to rank 0, which assembles them in global scene order
(padded, masked scenes are skipped as always; the host half is the whole
batch), and every rank returns rank 0's metric dict.  Only rank 0 prints
progress and writes ``save_dir``.

Spans (``utils.profiling``, recorded while a profiler session is active):
``eval.input`` (waiting for the loader's next item), ``eval.step`` (the eval
step, the rank functions, the pack and the D2H enqueue of one item, with its
``batches``: K for a group), ``eval.fetch`` (waiting for that copy, and the
gather to rank 0), ``eval.assemble`` (unpack, merge and host assembly) and
``eval.reduce`` (the metric dict after the loop).

Not ported: the 128-lane chunk trim (a TPU layout effect).
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vlsat_tpu_torch.data.pipeline import Prefetcher
from vlsat_tpu_torch.data.resident import gather_rows, take_batch
from vlsat_tpu_torch.data.wire import encode_wire
from vlsat_tpu_torch.eval.metrics import (
    compute_mean_predicate,
    discounted_ranks_device,
    get_mean_recall,
    get_zero_shot_recall,
    object_ranks,
    predicate_rank_parts,
    sorted_gt_preds_device,
    topk_accuracy,
    triplet_rank_parts,
)
from vlsat_tpu_torch.eval.recall import batched_scene_hits, tally_hits_batch
from vlsat_tpu_torch.parallel.mesh import shard_batch
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.utils import profiling
from vlsat_tpu_torch.utils.progbar import Progbar

SR_COMBOS = (("predcls", "rels"), ("sgcls", "triplet"))
SR_VARIANTS = (("gc", 1), ("ngc", 100))
SR_KEYS = tuple(f"{n}_{t}" for n, _ in SR_COMBOS for t, _ in SR_VARIANTS)
_INT_PARTS = ("obr", "prv", "trv")
_FLOAT_PARTS = ("probs_3d", "rel_cls_3d", "obj_logits_3d")


def _metric_parts(out: Dict[str, torch.Tensor], batch: SceneBatch, single_label: bool,
                  with_scores: bool, scene_recall: bool, gt_cap: Optional[int]
                  ) -> Dict[str, torch.Tensor]:
    """Rank tensors of a whole batch, on the outputs' device.

    ``single_label``: predicate ranks take the RAW log-probs (the 0.5 rule
    then compares log-space values, as the reference does) while triplet
    confidences take exp(log-probs); 'none' targets count as no-GT edges.
    ``gt_cap`` slices the (B, E, R) value and pred matrices to each edge's
    first ``gt_cap`` slots, which is exact when no edge has more GT
    predicates (checked on the host)."""
    parts: Dict[str, torch.Tensor] = {}
    tags = ("3d", "2d") if out.get("obj_logits_2d") is not None else ("3d",)
    gt_rels = batch.gt_rels
    if single_label:
        gt_rels = gt_rels.clone()
        gt_rels[..., 0] = 0
    # edges per triplet-rank chunk: its sorted (B, chunk, 101*R) candidates
    # and their sort indices stay at a few hundred MB
    chunk = max(8, min(batch.num_edges, 8192 // max(batch.num_scenes, 1)))
    for tag in tags:
        ol = out[f"obj_logits_{tag}"]
        rc = out[f"rel_cls_{tag}"]
        parts[f"obr_{tag}"] = object_ranks(ol, batch.gt_class, topk=11)
        pr, png = predicate_rank_parts(rc, topk=6)
        tr, tng = triplet_rank_parts(ol, batch.gt_class, torch.exp(rc) if single_label else rc,
                                     batch.edge_index, topk=101, chunk=chunk)
        parts[f"prv_{tag}"] = discounted_ranks_device(pr, png, gt_rels)[..., :gt_cap]
        parts[f"trv_{tag}"] = discounted_ranks_device(tr, tng, gt_rels)[..., :gt_cap]
    parts["preds"] = sorted_gt_preds_device(gt_rels)[..., :gt_cap]
    if with_scores:
        parts["probs_3d"] = torch.softmax(out["obj_logits_3d"].float(), dim=-1)
        rc3 = out["rel_cls_3d"]
        parts["rel_cls_3d"] = torch.exp(rc3) if single_label else rc3
        parts["obj_logits_3d"] = out["obj_logits_3d"]
    if scene_recall:
        rc3 = out["rel_cls_3d"]
        rc3 = torch.exp(rc3) if single_label else rc3
        for name, mode in SR_COMBOS:
            for tag, te in SR_VARIANTS:
                eg, hit = batched_scene_hits(
                    out["obj_logits_3d"], rc3, batch.edge_index, batch.edge_mask,
                    batch.gt_class, gt_rels, topk_each=te, kmax=100, mode=mode)
                parts[f"sre_{name}_{tag}"] = eg
                parts[f"srh_{name}_{tag}"] = hit
    return parts


def _pack(parts: Dict[str, torch.Tensor]
          ) -> Tuple[torch.Tensor, List[Tuple[str, tuple, np.dtype, int]]]:
    """All parts as one flat uint8 tensor, and its layout (name, shape,
    numpy dtype, byte offset).  Ranks travel as bytes (they are <= 255,
    guarded in ``evaluate``), hit flags as bytes, candidate edges as int32,
    scores as f32; each segment starts at a multiple of 4 bytes."""
    tags = ("3d", "2d") if "obr_2d" in parts else ("3d",)
    order = [(f"{n}_{t}", torch.uint8) for t in tags for n in _INT_PARTS]
    order.append(("preds", torch.uint8))
    order += [(f"srh_{k}", torch.uint8) for k in SR_KEYS if f"srh_{k}" in parts]
    order += [(f"sre_{k}", torch.int32) for k in SR_KEYS if f"sre_{k}" in parts]
    order += [(k, torch.float32) for k in _FLOAT_PARTS if k in parts]
    segs, layout, off = [], [], 0
    for name, dt in order:
        t = parts[name]
        flat = t.to(dt).reshape(-1).view(torch.uint8)
        pad = -flat.numel() % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        segs.append(flat)
        np_dt = {torch.uint8: np.uint8, torch.int32: np.int32, torch.float32: np.float32}[dt]
        layout.append((name, tuple(t.shape), np.dtype(np_dt), off))
        off += flat.numel()
    return torch.cat(segs), layout


def _unpack(buf: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """Invert ``_pack`` on the host: rank bytes widen to int32, hit flags
    to bool."""
    parts = {}
    for name, shape, dt, off in layout:
        n = int(np.prod(shape, dtype=np.int64))
        a = buf[off:off + n * dt.itemsize].view(dt).reshape(shape)
        if name.startswith("srh_"):
            a = a.astype(bool)
        elif dt == np.uint8:
            a = a.astype(np.int32)
        parts[name] = a
    return parts


def _gather_to_root(buf: torch.Tensor, world) -> Optional[List[torch.Tensor]]:
    """Every rank's host buffer (same shape on each), on rank 0; None on the
    others."""
    out = [torch.empty_like(buf) for _ in range(world.size)] if world.rank == 0 else None
    dist.gather(buf, out, dst=0, group=world.host_group)
    return out


def _from_rank0(metrics: Optional[Dict[str, float]], world) -> Dict[str, float]:
    """Rank 0's metric dict, on every rank."""
    box = [metrics]
    dist.broadcast_object_list(box, src=0, group=world.host_group)
    return box[0]


def _merge(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The ranks' unpacked parts of one batch, concatenated along the scene
    axis (rank r holds block r)."""
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _pin(batch: SceneBatch) -> SceneBatch:
    return batch.replace(**{k: v.pin_memory() for k, v in vars(batch).items()
                            if v is not None})


class _PinnedRing:
    """Reused page-locked host buffers for the packed device-to-host copies.
    Slot i serves items i, i + n, ...; ``evaluate`` keeps at most two items
    undrained, so a slot is never refilled before its item was assembled."""

    def __init__(self, slots: int = 3):
        self._bufs: List[Optional[torch.Tensor]] = [None] * slots
        self._next = 0

    def take(self, shape: Tuple[int, ...]) -> torch.Tensor:
        i = self._next % len(self._bufs)
        self._next += 1
        n = int(np.prod(shape, dtype=np.int64))
        if self._bufs[i] is None or self._bufs[i].numel() < n:
            self._bufs[i] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self._bufs[i][:n].view(shape)


def evaluate(eval_step, state, loader: Iterable, num_rel_classes: int = 26,
             train_triplet_vocab: Optional[set] = None, save_dir: Optional[str] = None,
             with_scores: bool = False, verbose: bool = True, total: Optional[int] = None,
             multi_rel: bool = True, scene_recall: bool = False) -> Dict[str, float]:
    """Metric suite of ``eval_step(state, batch)`` over ``loader``'s items:
    host ``SceneBatch``es (f32, on the CPU), sent to ``eval_step.device``
    (``train.step.make_eval_step`` sets it; the CPU without it) wire-encoded,
    from pinned memory on a card; ``(host, device)`` pairs, run on the device
    half and assembled from the host half; or, when ``loader.grouped`` is
    true, ``(hosts, full, idx)`` groups of ``data.resident.ResidentGroupedEval``
    (``idx`` (K, B) scene rows) or of ``ResidentShardedEval`` (``idx`` (K,)
    batch ids of its batch-stacked split).  A loader with ``mesh_sharded``
    evaluates data-parallel over its ``world`` (module docstring); every
    rank of the group must call ``evaluate`` with it.

    Reports object / predicate / triplet Acc@k, per-class mean predicate
    accuracy and mean recall for the 3D branch, and for the 2D branch when
    the step returns it; zero-shot recall with ``train_triplet_vocab``.

    ``multi_rel=False`` evaluates the single-label mode (heads emit
    log-probs over [none]+classes).  ``scene_recall=True`` adds the in21k
    scene-level predcls/sgcls R@{20,50,100} and their per-predicate means,
    graph-constrained (gc) and not (ngc), averaged over scenes with at least
    one GT relation.  A ``loader.max_gt`` attribute caps the shipped GT
    slots.  ``save_dir`` receives the reference's artifacts (rank lists,
    cls_matrix, with ``with_scores`` the score lists, result.txt)."""
    if 2 * num_rel_classes + 1 > 255:
        raise ValueError(
            "uint8 rank packing requires num_rel_classes <= 127: the discounted "
            "no-GT rank (R+2) plus the R-1 encode offset must fit a byte "
            f"(got {num_rel_classes})")
    dev = torch.device(getattr(eval_step, "device", "cpu"))
    on_card = dev.type == "cuda"
    world = loader.world if getattr(loader, "mesh_sharded", False) else None
    root = world is None or world.rank == 0
    acc = {k: [] for k in ("topk_obj", "topk_obj_2d", "topk_rel", "topk_rel_2d",
                           "topk_triplet", "topk_triplet_2d")}
    cls_rows, sub_scores, obj_scores, rel_scores = [], [], [], []
    sr_acc: Dict[str, list] = {k: [] for k in SR_KEYS}
    sr_cls: Dict[str, list] = {k: [] for k in SR_KEYS}
    progbar = Progbar(total, width=20) if verbose and root else None
    seen = 0
    prog_hits = {"obj": 0, "rel": 0, "trip": 0}
    prog_tot = {"obj": 0, "rel": 0, "trip": 0}
    gt_cap = getattr(loader, "max_gt", None)
    if gt_cap is not None:
        gt_cap = max(1, int(gt_cap))
    has_2d = True

    def _pct(key: str) -> float:
        t = prog_tot[key]
        return prog_hits[key] * 100.0 / t if t else 0.0

    def _assemble(p: Dict[str, np.ndarray], batch: SceneBatch) -> None:
        nonlocal seen, has_2d
        has_2d = "obr_2d" in p
        obj_mask = batch.obj_mask.numpy()
        edge_mask = batch.edge_mask.numpy()
        gt_rels = batch.gt_rels.numpy()
        if not multi_rel:
            gt_rels = gt_rels.copy()
            gt_rels[..., 0] = 0
        gt_class = batch.gt_class.numpy()
        edge_index = batch.edge_index.numpy()

        gt_f = gt_rels[edge_mask]
        off = gt_f.shape[-1] - 1                      # u8 encode offset
        cnt = (gt_f > 0).sum(axis=1)
        counts = np.maximum(cnt, 1)
        rc = p["prv_3d"].shape[-1]
        if rc < gt_f.shape[-1] and cnt.size and int(cnt.max()) > rc:
            raise ValueError(
                f"loader declared max_gt={rc} but a batch edge carries "
                f"{int(cnt.max())} GT relations")
        valid = np.arange(rc)[None, :] < counts[:, None]

        def _sel(key: str) -> np.ndarray:
            return (p[key][edge_mask].astype(np.int64) - off)[valid]

        obj_f3 = p["obr_3d"][obj_mask]
        rel_f3 = _sel("prv_3d")
        acc["topk_obj"].append(obj_f3)
        acc["topk_rel"].append(rel_f3)
        prog_hits["obj"] += int((obj_f3 <= 1).sum())
        prog_tot["obj"] += len(obj_f3)
        prog_hits["rel"] += int((rel_f3 <= 1).sum())
        prog_tot["rel"] += len(rel_f3)
        if has_2d:
            acc["topk_obj_2d"].append(p["obr_2d"][obj_mask])
            acc["topk_rel_2d"].append(_sel("prv_2d"))

        if edge_mask.any():
            bi = np.arange(batch.num_scenes)[:, None]
            sub_idx, obj_idx = edge_index[..., 0], edge_index[..., 1]
            sub_cls = gt_class[bi, sub_idx][edge_mask]
            obj_cls = gt_class[bi, obj_idx][edge_mask]
            rank_sub = p["obr_3d"][bi, sub_idx][edge_mask]
            rank_obj = p["obr_3d"][bi, obj_idx][edge_mask]
            trip_r = _sel("trv_3d")
            preds = p["preds"][edge_mask].astype(np.int64)[valid] - 1
            acc["topk_triplet"].append(trip_r)
            prog_hits["trip"] += int((trip_r <= 50).sum())
            prog_tot["trip"] += len(trip_r)
            rep = lambda a: np.repeat(np.asarray(a).astype(np.int64), counts)
            cls_rows.append(np.stack(
                [rep(sub_cls), rep(rank_sub), rep(obj_cls), rep(rank_obj), preds], axis=1))
            if has_2d:
                acc["topk_triplet_2d"].append(_sel("trv_2d"))
            if with_scores:
                keep = preds >= 0  # score rows exist only for GT predicates
                probs3 = p["probs_3d"]
                sub_scores.append(np.repeat(probs3[bi, sub_idx][edge_mask], counts,
                                            axis=0)[keep])
                obj_scores.append(np.repeat(probs3[bi, obj_idx][edge_mask], counts,
                                            axis=0)[keep])
                rel_scores.append(np.repeat(p["rel_cls_3d"][edge_mask].astype(np.float32),
                                            counts, axis=0)[keep])

        if scene_recall:
            for k in SR_KEYS:
                scalar, per_cls, ok = tally_hits_batch(
                    p[f"sre_{k}"], p[f"srh_{k}"], gt_rels, edge_mask,
                    topk=(20, 50, 100), num_rel_classes=num_rel_classes)
                if ok.any():
                    sr_acc[k].append(scalar[ok])
                    sr_cls[k].append(per_cls[ok])

        seen += int((obj_mask.sum(axis=1) > 0).sum())
        if progbar is not None:
            progbar.update(seen, [("Acc@1/obj", _pct("obj")), ("Acc@1/rel", _pct("rel")),
                                  ("Acc@50/trip", _pct("trip"))])

    grouped = bool(getattr(loader, "grouped", False))

    def _prepare(it):
        # host side of the H2D copy, off the main thread: wire-encode and pin
        for item in it:
            if grouped:
                hosts, full, idx = item
                idx = torch.from_numpy(np.ascontiguousarray(idx))
                if idx.dim() == 2:  # scene rows, gathered on the device
                    idx = idx.pin_memory() if on_card else idx
                yield hosts, (full, idx)
            elif isinstance(item, tuple):
                yield item  # (host, device): nothing to copy
            else:
                wire = encode_wire(item)
                if world is not None:
                    wire = shard_batch(wire, world)  # this rank's block only
                yield item, (_pin(wire) if on_card else wire)

    def _parts(dev_batch: SceneBatch) -> Tuple[torch.Tensor, list]:
        out = eval_step(state, dev_batch)
        return _pack(_metric_parts(out, dev_batch, single_label=not multi_rel,
                                   with_scores=with_scores, scene_recall=scene_recall,
                                   gt_cap=gt_cap))

    def _drain(entry) -> None:
        buf, layout, event, payload = entry
        with profiling.span("eval.fetch"):
            if event is not None:
                event.synchronize()
            bufs = [buf] if world is None else _gather_to_root(buf, world)
        if bufs is None:  # not rank 0: rank 0 assembles
            return
        with profiling.span("eval.assemble"):
            if grouped:  # row j of the (K, n) buffer is batch j; tail rows are skipped
                for j, host in enumerate(payload):
                    _assemble(_merge([_unpack(b[j].numpy(), layout) for b in bufs]), host)
            else:
                _assemble(_merge([_unpack(b.numpy(), layout) for b in bufs]), payload)

    ring = _PinnedRing()
    pending: deque = deque()
    items = iter(Prefetcher(_prepare(loader), depth=2))
    while True:
        with profiling.span("eval.input"):
            item = next(items, None)
        if item is None:
            break
        payload, dev_in = item
        with profiling.span("eval.step", batches=dev_in[1].shape[0] if grouped else 1), \
                torch.inference_mode():
            if grouped:
                full, idx = dev_in
                if idx.dim() == 1:  # batch ids of a batch-stacked split
                    batches = [take_batch(full, int(k)) for k in idx]
                else:
                    rows = idx.to(dev, non_blocking=True)
                    batches = [gather_rows(full, rows[k]) for k in range(rows.shape[0])]
                flats = []
                for b in batches:
                    flat, layout = _parts(b)
                    flats.append(flat)
                flat = torch.stack(flats)
            else:
                flat, layout = _parts(dev_in.to(dev, non_blocking=True))
            event = None
            if flat.is_cuda:
                buf = ring.take(tuple(flat.shape))
                buf.copy_(flat, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                buf = flat
        pending.append((buf, layout, event, payload))
        # batch k is assembled once batch k+1 is queued on the device
        while len(pending) > 1:
            _drain(pending.popleft())
    while pending:
        _drain(pending.popleft())

    if not root:  # rank 0 assembled every batch
        return _from_rank0(None, world)
    with profiling.span("eval.reduce"):
        arr = {k: (np.concatenate(v) if v else np.zeros(0, np.int64)) for k, v in acc.items()}
        cls_matrix = np.concatenate(cls_rows) if cls_rows else np.zeros((0, 5), np.int64)

        metrics: Dict[str, float] = {}
        families = [("obj_acc", "topk_obj", (1, 5, 10)), ("rel_acc", "topk_rel", (1, 3, 5)),
                    ("triplet_acc", "topk_triplet", (50, 100))]
        if has_2d:
            families += [("obj_acc_2d", "topk_obj_2d", (1, 5, 10)),
                         ("rel_acc_2d", "topk_rel_2d", (1, 3, 5)),
                         ("triplet_acc_2d", "topk_triplet_2d", (50, 100))]
        for name, key, ks in families:
            for k in ks:
                metrics[f"{name}_{k}"] = topk_accuracy(arr[key], k)

        m1, m3, m5 = compute_mean_predicate(cls_matrix, arr["topk_rel"],
                                            num_rel_classes=num_rel_classes)
        metrics.update(rel_acc_mean_1=m1, rel_acc_mean_3=m3, rel_acc_mean_5=m5)
        mr = get_mean_recall(arr["topk_triplet"], cls_matrix, num_rel_classes=num_rel_classes)
        metrics.update(mean_recall_50=float(mr[0]), mean_recall_100=float(mr[1]))
        if has_2d:
            m1_2, m3_2, m5_2 = compute_mean_predicate(cls_matrix, arr["topk_rel_2d"],
                                                      num_rel_classes=num_rel_classes)
            metrics.update(rel_acc_2d_mean_1=m1_2, rel_acc_2d_mean_3=m3_2,
                           rel_acc_2d_mean_5=m5_2)
            mr2 = get_mean_recall(arr["topk_triplet_2d"], cls_matrix,
                                  num_rel_classes=num_rel_classes)
            metrics.update(mean_recall_2d_50=float(mr2[0]), mean_recall_2d_100=float(mr2[1]))

        if train_triplet_vocab is not None:
            metrics.update(get_zero_shot_recall(arr["topk_triplet"], cls_matrix,
                                                train_triplet_vocab))

        if scene_recall:
            ks = (20, 50, 100)
            for key, vals in sr_acc.items():
                stacked = np.concatenate(vals) if vals else np.full((1, len(ks)), np.nan)
                for i, k in enumerate(ks):
                    metrics[f"{key}_recall_{k}"] = float(np.nanmean(stacked[:, i]) * 100)
            for key, vals in sr_cls.items():
                stacked = (np.concatenate(vals) if vals
                           else np.full((1, num_rel_classes, len(ks)), -1.0))
                masked = np.where(stacked >= 0, stacked, np.nan)  # -1 = class absent
                with np.errstate(invalid="ignore"):
                    cls_mean = np.nanmean(masked, axis=0)
                    for i, k in enumerate(ks):
                        metrics[f"{key}_mean_recall_{k}"] = float(
                            np.nanmean(cls_mean[:, i]) * 100)

        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            np.save(os.path.join(save_dir, "topk_pred_list.npy"), arr["topk_rel"])
            np.save(os.path.join(save_dir, "topk_triplet_list.npy"), arr["topk_triplet"])
            np.save(os.path.join(save_dir, "cls_matrix_list.npy"), cls_matrix)
            if with_scores and sub_scores:
                np.save(os.path.join(save_dir, "sub_scores_list.npy"), np.concatenate(sub_scores))
                np.save(os.path.join(save_dir, "obj_scores_list.npy"), np.concatenate(obj_scores))
                np.save(os.path.join(save_dir, "rel_scores_list.npy"), np.concatenate(rel_scores))
            with open(os.path.join(save_dir, "result.txt"), "w") as f:
                for k, v in metrics.items():
                    print(f"Eval: {k}: {v}", file=f)

    return metrics if world is None else _from_rank0(metrics, world)
