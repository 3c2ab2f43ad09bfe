"""Relationship-JSON generation from segmented scans (counterpart of
``vlsat_tpu/preprocess/gen_data.py``, host work with the same
``np.random.RandomState`` draws).

It follows data_processing/gen_data_gt.py (GT segmentation) and the
scene-splitting machinery: large scans are split into subgraph groups by
seed sampling + bbox neighbor growth (gen_data_gt.py:48-172), and each
group becomes one scan-split entry in the relationships JSON — the unit
the training pipeline consumes.

The estimated-segmentation variant (gen_data.py) maps predicted segments
to GT instances by overlap before inheriting relations; ``map_segments``
implements that correspondence search.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from vlsat_tpu_torch.data.sampling import build_neighbor_graph


def sample_seed_points(points: np.ndarray, distance: float = 1.0,
                       rng: Optional[np.random.RandomState] = None) -> List[int]:
    """Greedy xy-plane Poisson-disk-ish seeds (gen_data_gt.py:58-74):
    repeatedly pick a random point farther than ``distance`` (in xy) from
    every selected seed."""
    rng = rng or np.random.RandomState(0)
    idx = int(rng.choice(len(points)))
    selected = [idx]
    min_d = np.linalg.norm(points[:, :2] - points[idx, :2], axis=1)
    while True:
        selectable = np.nonzero(min_d > distance)[0]
        if len(selectable) < 1:
            break
        idx = int(rng.choice(selectable))
        selected.append(idx)
        d = np.linalg.norm(points[:, :2] - points[idx, :2], axis=1)
        min_d = np.minimum(min_d, d)
    return selected


def bbox_groups(points: np.ndarray, segments: np.ndarray, seeds: Sequence[int],
                bbox_distance: float = 0.75, min_seg_per_group: int = 5) -> List[List[int]]:
    """Instance-id groups per seed bbox (gen_data_gt.py:97-113)."""
    groups: List[List[int]] = []
    for s in seeds:
        lo = points[s] - bbox_distance
        hi = points[s] + bbox_distance
        inside = np.all((points > lo) & (points < hi), axis=1)
        ids = np.unique(segments[inside])
        ids = ids[ids != 0]
        if len(ids) < min_seg_per_group:
            continue
        groups.append([int(i) for i in ids])
    return groups


def layered_growth_groups(
    seeds: Sequence[int],
    segments: np.ndarray,
    neighbor_graph: Dict[int, Set[int]],
    n_layers: int = 2,
    min_seg_per_group: int = 5,
) -> List[List[int]]:
    """Instance-id groups by layered neighbor growth — the reference
    generator's DEFAULT split method (``--split_method KNN``,
    gen_data_gt.py:42,121-172): each seed point's segment is grown
    ``n_layers`` times over the segment-neighbor graph; the group is the
    union of the seed segment and every layer.  (The reference also
    differences later layers against earlier ones, but only for a debug
    print — the appended group is the plain union; and it builds per-segment
    KD-trees/radius-padded bboxes it never reads in this path.)  Groups
    smaller than ``min_seg_per_group`` are dropped, like the BBOX method.

    ``seeds`` are point indices (from :func:`sample_seed_points`);
    ``segments`` the per-point instance/segment ids; ``neighbor_graph``
    a segment adjacency (:func:`build_neighbor_graph`, the counterpart of
    the reference's ``find_neighbors`` with ``--radius_receptive``).
    """
    groups: List[List[int]] = []
    for idx in seeds:
        seg_id = int(segments[idx])
        neighbors: Set[int] = {seg_id}
        frontier: Set[int] = {seg_id}
        for _ in range(n_layers):
            layer: Set[int] = set()
            for j in frontier:
                layer |= set(int(x) for x in neighbor_graph.get(j, ()))
            # the reference grows from the full accumulated set each layer
            # (``for j in neighbors``); track it the same way
            neighbors |= layer
            frontier = set(neighbors)
        if len(neighbors) < min_seg_per_group:
            continue
        groups.append(sorted(int(i) for i in neighbors))
    return groups


def generate_groups(
    points: np.ndarray,
    segments: np.ndarray,
    split_method: str = "KNN",
    distance: float = 1.0,
    bbox_distance: float = 0.75,
    min_seg_per_group: int = 5,
    n_layers: int = 2,
    neighbor_graph: Optional[Dict[int, Set[int]]] = None,
    neighbor_radius: float = 0.5,
    rng: Optional[np.random.RandomState] = None,
) -> List[List[int]]:
    """Scene -> subgraph groups, dispatching on the reference's
    ``--split_method`` enum (gen_data_gt.py:42,87-99): ``"KNN"`` (default)
    = seed sampling + layered neighbor growth, ``"BBOX"`` = seed sampling +
    fixed bbox crop."""
    rng = rng or np.random.RandomState(0)
    seeds = sample_seed_points(points, distance=distance, rng=rng)
    if split_method == "BBOX":
        return bbox_groups(points, segments, seeds,
                           bbox_distance=bbox_distance,
                           min_seg_per_group=min_seg_per_group)
    if split_method != "KNN":
        raise ValueError(f"split_method must be 'KNN' or 'BBOX', got {split_method!r}")
    if neighbor_graph is None:
        neighbor_graph = build_neighbor_graph(points, segments,
                                              radius=neighbor_radius, rng=rng)
    return layered_growth_groups(seeds, segments, neighbor_graph,
                                 n_layers=n_layers,
                                 min_seg_per_group=min_seg_per_group)


def split_scene_relationships(
    scan_id: str,
    instance_names: Dict[int, str],
    relationships: Sequence[Sequence],
    groups: Sequence[Sequence[int]],
) -> List[dict]:
    """One relationships-JSON 'scans' entry per group, keeping only
    relations with both endpoints inside the group."""
    entries = []
    for split_idx, group in enumerate(groups, start=1):
        gset = set(group)
        objs = {str(i): instance_names[i] for i in group if i in instance_names}
        rels = [list(r) for r in relationships
                if r[0] in gset and r[1] in gset]
        entries.append({
            "scan": scan_id,
            "split": split_idx,
            "objects": objs,
            "relationships": rels,
        })
    return entries


def map_segments(
    pred_points: np.ndarray, pred_segments: np.ndarray,
    gt_points: np.ndarray, gt_instances: np.ndarray,
    max_dist: float = 0.1, occ_thres: float = 0.5,
) -> Dict[int, int]:
    """Estimated-segmentation -> GT-instance correspondence
    (gen_data.py:--max_dist/--occ_thres semantics): a predicted segment
    maps to the GT instance owning the majority of its points' nearest GT
    neighbors (within max_dist), if that majority passes occ_thres."""
    mapping: Dict[int, int] = {}
    for seg in np.unique(pred_segments):
        if seg == 0:
            continue
        pts = pred_points[pred_segments == seg]
        # chunked brute-force nearest neighbor (no scipy dependency)
        votes: Dict[int, int] = {}
        for i in range(0, len(pts), 512):
            chunk = pts[i:i + 512]
            d2 = np.square(chunk[:, None, :] - gt_points[None, :, :]).sum(-1)
            nn = np.argmin(d2, axis=1)
            ok = np.sqrt(d2[np.arange(len(chunk)), nn]) <= max_dist
            for inst in gt_instances[nn[ok]]:
                votes[int(inst)] = votes.get(int(inst), 0) + 1
        if not votes:
            continue
        best, cnt = max(votes.items(), key=lambda kv: kv[1])
        if best != 0 and cnt / len(pts) >= occ_thres:
            mapping[int(seg)] = best
    return mapping


def clean_gt_segment_labels(
    segments_gt: np.ndarray, labels_gt: np.ndarray, min_seg_size: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve GT segments carrying multiple labels (ScanNet aggregation
    noise), per gen_data_scannet.py:95-135: keep the majority label; a
    minority label's points either become a NEW segment (when that label
    has more than ``min_seg_size`` points) or are zeroed out of both
    arrays.  NOTE the reference's size check reads a stale loop variable
    (``labels==id`` where ``id`` is left over from the counting loop,
    gen_data_scannet.py:117) so it compares the wrong label's size; we
    implement the evident intent (per-minority-label size).

    Returns cleaned (segments, labels) copies.
    """
    segments = segments_gt.copy()
    labels = labels_gt.copy()
    next_seg = int(segments.max()) + 1
    for seg_id in np.unique(segments):
        idx = np.where(segments == seg_id)[0]
        uq = np.unique(labels[idx])
        if len(uq) <= 1:
            continue
        counts = {int(l): int((labels[idx] == l).sum()) for l in uq}
        major = max(counts, key=counts.get)
        for label, count in counts.items():
            if label == major:
                continue
            sel = idx[labels[idx] == label]
            if count > min_seg_size:
                segments[sel] = next_seg
                next_seg += 1
            else:
                segments[sel] = 0
                labels[sel] = 0
    return segments, labels


def map_segments_scannet(
    pred_points: np.ndarray, pred_segments: np.ndarray,
    gt_points: np.ndarray, gt_segments: np.ndarray,
    instance_names: Dict[int, str],
    max_dist: float = 0.1, min_seg_size: int = 512,
    corr_thres: float = 0.5, occ_thres: float = 0.75,
) -> Tuple[Dict[int, int], Dict[int, List[int]]]:
    """Predicted-segment -> GT-segment correspondence with the reference's
    two-threshold rule (gen_data_scannet.py:157-242):

      * segments below ``min_seg_size`` points are skipped;
      * each predicted point votes for the GT segment of its nearest GT
        point within ``max_dist`` (votes to segments named 'none' or
        missing from ``instance_names`` are discarded);
      * the winner needs vote_count / segment_size > ``corr_thres``;
      * ambiguity filter: with more than two candidates, the
        second-best/best ratio must stay below ``occ_thres`` (the
        reference computes this only when >2 candidates exist — a
        2-candidate tie passes unfiltered; replicated).

    Returns (pd->gt mapping, gt->list-of-pd groups), the inputs of
    :func:`same_part_relationships` / :func:`gen_scannet_relationships`.
    """
    mapping: Dict[int, int] = {}
    gt_groups: Dict[int, List[int]] = {}
    for seg in np.unique(pred_segments):
        if seg == 0:
            continue
        pts = pred_points[pred_segments == seg]
        # keep segments with size >= min_seg_size (reference skips only
        # size < filter_segment_size, gen_data_scannet.py:169-170)
        if len(pts) < min_seg_size:
            continue
        votes: Dict[int, int] = {}
        for i in range(0, len(pts), 512):
            chunk = pts[i:i + 512]
            d2 = np.square(chunk[:, None, :] - gt_points[None, :, :]).sum(-1)
            nn = np.argmin(d2, axis=1)
            ok = np.sqrt(d2[np.arange(len(chunk)), nn]) <= max_dist
            for inst in gt_segments[nn[ok]]:
                inst = int(inst)
                name = instance_names.get(inst)
                if name is None or name == "none":
                    continue
                votes[inst] = votes.get(inst, 0) + 1
        if not votes:
            continue
        ratios = sorted((c / len(pts) for c in votes.values()), reverse=True)
        best, cnt = max(votes.items(), key=lambda kv: kv[1])
        occ_ratio = ratios[1] / ratios[0] if len(ratios) > 2 else 0.0
        if ratios[0] > corr_thres and occ_ratio < occ_thres:
            mapping[int(seg)] = best
            gt_groups.setdefault(best, []).append(int(seg))
    return mapping, gt_groups


def gen_scannet_relationships(
    scan_id: str,
    mapping: Dict[int, int],
    instance_names: Dict[int, str],
    gt_groups: Dict[int, List[int]],
    split: int = 0,
    rel_name: str = "same part",
    target_segments: Optional[Sequence[int]] = None,
) -> dict:
    """One relationships-JSON entry for a ScanNet scan
    (gen_data_scannet.py:268-302): objects named by their corresponding GT
    instance, relations = bidirectional 'same part' pairs of predicted
    segments sharing a GT segment."""
    objects = {}
    for seg, gt in mapping.items():
        if target_segments is not None and seg not in target_segments:
            continue
        name = instance_names[gt]
        assert name not in ("-", "none")
        objects[int(seg)] = name
    rels: List[list] = []
    for group in gt_groups.values():
        if target_segments is not None:
            group = [g for g in group if g in target_segments]
        if len(group) <= 1:
            continue
        for i in range(len(group)):
            for j in range(i + 1, len(group)):
                rels.append([int(group[i]), int(group[j]), 0, rel_name])
                rels.append([int(group[j]), int(group[i]), 0, rel_name])
    return {"scan": scan_id, "split": split, "objects": objects,
            "relationships": rels}


def same_part_relationships(
    seg_to_gt: Dict[int, int], rel_index: int = 0, rel_name: str = "same part",
    target_segments: Optional[Sequence[int]] = None,
) -> List[list]:
    """ScanNet-style 'same part' relations (gen_data_scannet.py:286-300):
    every ordered pair of predicted segments mapping to the same GT
    instance, both directions."""
    by_gt: Dict[int, List[int]] = {}
    for seg, gt in seg_to_gt.items():
        if target_segments is not None and seg not in target_segments:
            continue
        by_gt.setdefault(gt, []).append(seg)
    rels: List[list] = []
    for group in by_gt.values():
        if len(group) <= 1:
            continue
        for i in range(len(group)):
            for j in range(i + 1, len(group)):
                rels.append([int(group[i]), int(group[j]), rel_index, rel_name])
                rels.append([int(group[j]), int(group[i]), rel_index, rel_name])
    return rels


def train_valid_split(scan_ids: Sequence[str], valid_fraction: float = 0.1,
                      seed: int = 2020) -> Tuple[List[str], List[str]]:
    """90/10 split (data_processing/generate_train_valid_test_splits.py)."""
    rng = np.random.RandomState(seed)
    ids = list(scan_ids)
    rng.shuffle(ids)
    n_valid = max(1, int(round(len(ids) * valid_fraction)))
    return sorted(ids[n_valid:]), sorted(ids[:n_valid])
