"""3DSSG scene-graph dataset: preprocessing, caching, batching (counterpart of
``vlsat_tpu/data/dataset.py``, with the same semantics and random draws).

Counterpart of the reference's ``SSGDatasetGraph`` + ``collate_fn_mmg``
(src/dataset/dataset_3dssg.py:60-367, src/dataset/DataLoader.py:153-176),
re-designed around two pathologies of the original:

  * the reference re-loads the scan PLY with trimesh on EVERY __getitem__
    (dataset_3dssg.py:146) — here parsed scans are cached (in-memory LRU +
    optional on-disk .npz), while per-epoch random point sampling is kept
    (caching sampled tensors would freeze the data augmentation the
    reference gets from resampling);
  * variable scene shapes — scenes are padded into node-count buckets and
    batched with an explicit scene axis (see ``vlsat_tpu_torch.scene``).

Semantics preserved: nodes are the annotated instances present in the
mesh; edges are all ordered pairs minus self-loops; 128 points sampled
with replacement per instance; the 11-dim descriptor is computed on the
raw sampled points before zero-meaning; GT predicates are multi-hot; a
training scene with no relations is replaced by a random other scene
(dataset_3dssg.py:163-171).
"""

from __future__ import annotations

import os
import zipfile
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from vlsat_tpu_torch.data.assets import DatasetIndex, build_index, load_relationship_json
from vlsat_tpu_torch.data.ply import compute_vertex_normals, read_ply_vertices
from vlsat_tpu_torch.data.weights import count_occurrences, normalized_weights
from vlsat_tpu_torch.ops.descriptor import gen_descriptor
from vlsat_tpu_torch.scene import SceneBatch, collate, full_edge_index, pad_scene, pick_bucket


def _descriptor_np(pts: np.ndarray) -> np.ndarray:
    """The 11-dim descriptor of (P, 3) raw points, on the CPU."""
    return gen_descriptor(torch.from_numpy(np.ascontiguousarray(pts, np.float32)))\
        .numpy()


class SSGScenes:
    """Preprocessed access to one split of the 3DSSG dataset."""

    def __init__(
        self,
        root: str,
        scans_root: str,
        split: str,
        label_file: str = "labels.instances.align.annotated.v2.ply",
        num_points: int = 128,
        num_points_union: int = 256,
        multi_view_root: Optional[str] = None,
        cache_root: Optional[str] = None,
        with_union_points: bool = False,
        feat_dim: int = 512,
        multi_rel: bool = True,
        mesh_cache_size: int = 8,
        triplet_text_lookup=None,
        use_native: bool = True,
        all_edges: bool = True,
        use_data_augmentation: bool = False,
        sample_in_runtime: bool = False,
        sample_num_nn: int = 1,
        sample_num_seed: int = 1,
        sample_use_all: bool = False,
        max_edges: int = -1,
        neighbor_radius: float = 0.5,
        use_rgb: bool = False,
        use_normal: bool = False,
    ):
        self.scans_root = scans_root
        self.label_file = label_file
        self.num_points = num_points
        self.num_points_union = num_points_union
        self.multi_view_root = multi_view_root
        self.cache_root = cache_root
        self.with_union_points = with_union_points
        self.feat_dim = feat_dim
        self.multi_rel = multi_rel
        self.triplet_text_lookup = triplet_text_lookup
        self.all_edges = all_edges
        self.use_data_augmentation = use_data_augmentation
        # runtime BFS subgraph sampling (utils/util_data.py:61-95; config
        # keys sample_in_runtime / sample_num_nn / sample_num_seed /
        # max_edges, config/mmgnet.json:79-83)
        self.sample_in_runtime = sample_in_runtime
        self.sample_num_nn = sample_num_nn
        self.sample_num_seed = sample_num_seed
        self.sample_use_all = sample_use_all
        self.max_edges = max_edges
        self.neighbor_radius = neighbor_radius
        # extra point channels: xyz [+rgb/255] [+normals], appended in the
        # reference's load_mesh (dataset_3dssg.py:38-58); descriptors,
        # zero-meaning and bboxes always use the xyz slice only
        self.use_rgb = use_rgb
        self.use_normal = use_normal
        self.dim_pts = 3 + 3 * int(use_rgb) + 3 * int(use_normal)
        self._neighbor_cache: Dict[str, Dict[int, set]] = {}

        data = load_relationship_json(root, split)
        # ScanNet-style relationship JSONs carry a precomputed neighbor
        # graph per scan (gen_data_scannet.py writes 'neighbors')
        self._neighbors_json = data.get("neighbors", {}) if isinstance(data, dict) else {}
        self.index: DatasetIndex = build_index(root, split, data=data,
                                               multi_rel=multi_rel, label_file=label_file)
        self.class_names = self.index.class_names
        self.relation_names = self.index.relation_names
        obj_counts, rel_counts = count_occurrences(
            self.class_names, self.relation_names, data,
            [s.scan for s in self.index.scenes],
        )
        self.w_cls_obj = normalized_weights(obj_counts)
        self.w_cls_rel = normalized_weights(rel_counts, none_boost=not multi_rel)

        self._mesh_cache: OrderedDict[str, dict] = OrderedDict()
        self._mesh_cache_size = mesh_cache_size
        if cache_root:
            os.makedirs(cache_root, exist_ok=True)
        self._native = None
        if use_native:
            from vlsat_tpu_torch import native as _native_mod

            self._native = _native_mod.load()  # None -> NumPy fallback

    def __len__(self) -> int:
        return len(self.index.scenes)

    # ------------------------------------------------------------------ mesh
    def _load_mesh(self, scan: str) -> dict:
        if scan in self._mesh_cache:
            self._mesh_cache.move_to_end(scan)
            return self._mesh_cache[scan]
        suffix = ("" if self.dim_pts == 3
                  else f".c{int(self.use_rgb)}{int(self.use_normal)}")
        npz_path = (os.path.join(self.cache_root, f"{scan}{suffix}.npz")
                    if self.cache_root else None)
        mesh = None
        if npz_path and os.path.exists(npz_path):
            # tolerate a torn/partial cache file (e.g. killed writer from a
            # pre-atomic-write build): fall through to re-parse + rewrite
            try:
                with np.load(npz_path) as z:
                    mesh = {"points": z["points"], "instances": z["instances"]}
            except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
                mesh = None
        if mesh is None:
            path = os.path.join(self.scans_root, scan, self.label_file)
            mesh = None
            if self._native is not None and self.dim_pts == 3:
                try:
                    pts, inst = self._native.read_ply(path)
                    mesh = {"points": pts, "instances": inst}
                except IOError:
                    mesh = None
            if mesh is None:
                ply = read_ply_vertices(path, with_faces=self.use_normal)
                if ply.instances is None:
                    raise ValueError(f"{scan}: PLY has no objectId/label attribute")
                chans = [ply.points]
                if self.use_rgb:
                    if ply.colors is None:
                        raise ValueError(f"{scan}: USE_RGB but PLY has no vertex colors")
                    chans.append(ply.colors.astype(np.float32) / 255.0)
                if self.use_normal:
                    normals = ply.normals
                    if normals is None:
                        if ply.faces is None or not len(ply.faces):
                            raise ValueError(
                                f"{scan}: USE_NORMAL but PLY has neither normals nor faces")
                        normals = compute_vertex_normals(ply.points, ply.faces)
                    chans.append(normals)
                pts = (np.concatenate(chans, axis=1).astype(np.float32)
                       if len(chans) > 1 else ply.points)
                mesh = {"points": pts, "instances": ply.instances}
            if npz_path:
                # uncompressed: savez_compressed made cache-building ~5x
                # slower than the parse it caches (~450 KB/scan raw —
                # ~0.5 GB for the full 3RScan split, cheap on disk).
                # Written atomically (tmp + os.replace): parallel pack
                # workers share this cache and 3DSSG has multiple scenes
                # per scan, so two processes can hit the same scan
                # concurrently — a non-atomic savez left torn files that
                # poisoned later runs.  The tmp name keeps the .npz suffix
                # (np.savez appends it otherwise) and is per-pid so
                # concurrent writers never collide; both produce the same
                # bytes, so last-replace-wins is benign.
                tmp = f"{npz_path}.{os.getpid()}.tmp.npz"
                try:
                    np.savez(tmp, **mesh)
                    os.replace(tmp, npz_path)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
        self._mesh_cache[scan] = mesh
        while len(self._mesh_cache) > self._mesh_cache_size:
            self._mesh_cache.popitem(last=False)
        return mesh

    # ------------------------------------------------------------- neighbors
    def _neighbor_graph(self, scan: str, points: np.ndarray,
                        instances: np.ndarray) -> Dict[int, set]:
        """Segment-neighbor graph for runtime sampling: the precomputed
        'neighbors' entry of the relationships JSON when present (the
        ScanNet generator writes one), else computed from point proximity
        (``data.sampling.build_neighbor_graph``) and memoized per scan."""
        if scan in self._neighbor_cache:
            return self._neighbor_cache[scan]
        if scan in self._neighbors_json:
            nns = {int(k): set(int(x) for x in v)
                   for k, v in self._neighbors_json[scan].items()}
        else:
            from vlsat_tpu_torch.data.sampling import build_neighbor_graph

            nns = build_neighbor_graph(points[:, :3], instances,
                                       radius=self.neighbor_radius)
        self._neighbor_cache[scan] = nns
        return nns

    # ----------------------------------------------------------------- scene
    def prepare(self, i: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        ann = self.index.scenes[i]
        mesh = self._load_mesh(ann.scan)
        points, instances = mesh["points"], mesh["instances"]
        if self.use_data_augmentation:
            # random z-rotation of the whole scene (the reference defines
            # but never calls its data_augmentation; here the flag works)
            from vlsat_tpu_torch.data.augment import random_z_rotation

            points = random_z_rotation(
                points, rng,
                normal_offset=3 + 3 * int(self.use_rgb) if self.use_normal else None)

        present = set(np.unique(instances).tolist())
        present.discard(0)  # background
        nodes = [iid for iid in ann.objects if iid in present]
        n = len(nodes)
        if n == 0:
            raise ValueError(f"{ann.scan_id}: no annotated instance present in mesh")

        sampled_edges = None  # instance-id pairs when sampling in runtime
        if self.sample_in_runtime:
            from vlsat_tpu_torch.data.sampling import (
                bfs_neighbor_selection, edges_from_selection, subsample_edges)

            nns = self._neighbor_graph(ann.scan, points, instances)
            if self.sample_use_all:
                selection = list(nodes)
            else:
                selection = sorted(bfs_neighbor_selection(
                    nns, nodes, self.sample_num_nn, self.sample_num_seed, rng))
                if not selection:
                    selection = list(nodes)  # degenerate draw: keep the scene usable
            sampled_edges = subsample_edges(
                edges_from_selection(selection, nns, rng=rng),
                self.max_edges, rng)
            nodes = [iid for iid in nodes if iid in set(selection)]
            n = len(nodes)

        obj_2d = np.zeros((n, self.feat_dim), np.float32)
        gt_class = np.zeros((n,), np.int32)
        boxes = {}
        use_native = (self._native is not None and not self.with_union_points
                      and self.dim_pts == 3)
        if use_native:
            seed = int(rng.randint(0, 2**31 - 1))
            obj_points, descriptor = self._native.prepare_instances(
                points, instances, nodes, self.num_points, seed)
        else:
            obj_points = np.zeros((n, self.num_points, self.dim_pts), np.float32)
            descriptor = np.zeros((n, 11), np.float32)
        for k, iid in enumerate(nodes):
            name = ann.objects[iid]
            gt_class[k] = self.class_names.index(name)
            if not use_native:
                sel = points[instances == iid]
                boxes[iid] = (sel[:, :3].min(0) - 0.2, sel[:, :3].max(0) + 0.2)
                choice = rng.choice(len(sel), self.num_points, replace=True)
                sample = sel[choice].astype(np.float32)
                # descriptor / zero-mean act on the xyz slice only
                # (dataset_3dssg.py:291-293); rgb/normal channels pass through
                descriptor[k] = _descriptor_np(sample[:, :3])
                sample[:, :3] -= sample[:, :3].mean(0, keepdims=True)
                obj_points[k] = sample
            if self.multi_view_root is not None:
                fp = os.path.join(
                    self.multi_view_root, "data", "3RScan", ann.scan, "multi_view",
                    f"instance_{iid}_class_{name}_origin_view_mean.npy",
                )
                obj_2d[k] = np.load(fp)

        if sampled_edges is not None:
            pos = {iid: k for k, iid in enumerate(nodes)}
            pairs = [(pos[a], pos[b]) for a, b in sampled_edges
                     if a in pos and b in pos]
            edge_index = (np.asarray(pairs, np.int32).reshape(-1, 2)
                          if pairs else np.zeros((0, 2), np.int32))
        elif self.all_edges:
            edge_index = full_edge_index(n)
        else:
            # annotated-pairs-only edges (the reference's all_edge=False
            # branch, dataset_3dssg.py:267-268)
            pairs = sorted({
                (nodes.index(r[0]), nodes.index(r[1]))
                for r in ann.relationships if r[0] in nodes and r[1] in nodes
            })
            edge_index = (np.asarray(pairs, np.int32).reshape(-1, 2)
                          if pairs else np.zeros((0, 2), np.int32))
        e = len(edge_index)
        n_rel = len(self.relation_names)
        if self.multi_rel:
            adj = np.zeros((n, n, n_rel), np.float32)
            for r in ann.relationships:
                if r[0] not in nodes or r[1] not in nodes:
                    continue
                if r[3] not in self.relation_names:
                    raise ValueError(f"{ann.scan_id}: invalid relation {r[3]!r}")
                adj[nodes.index(r[0]), nodes.index(r[1]),
                    self.relation_names.index(r[3])] = 1
            gt_rels = (adj[edge_index[:, 0], edge_index[:, 1]] if e
                       else np.zeros((0, n_rel), np.float32))
        else:
            # single-label mode: class 0 = 'none' (kept in relation_names);
            # last annotation wins as in the reference adj_matrix
            adj = np.zeros((n, n), np.int64)
            for r in ann.relationships:
                if r[0] not in nodes or r[1] not in nodes:
                    continue
                adj[nodes.index(r[0]), nodes.index(r[1])] = \
                    self.relation_names.index(r[3])
            labels = adj[edge_index[:, 0], edge_index[:, 1]] if e else np.zeros(0, np.int64)
            gt_rels = np.zeros((e, n_rel), np.float32)
            if e:
                gt_rels[np.arange(e), labels] = 1

        out = dict(
            obj_points=obj_points, descriptor=descriptor, obj_2d_feats=obj_2d,
            gt_class=gt_class, edge_index=edge_index, gt_rels=gt_rels,
        )
        if self.with_union_points:
            # always emit (zero-sized for edge-less scenes) so batched
            # collate sees a consistent key set
            out["rel_points"] = (
                self._union_points(points, instances, nodes, boxes, edge_index, rng)
                if e else np.zeros((0, self.num_points_union, self.dim_pts + 1),
                                   np.float32)
            )
        if self.triplet_text_lookup is not None:
            out["rel_text_feat"] = self.triplet_text_lookup(
                gt_class, gt_rels, edge_index
            )
        return out

    def _union_points(self, points, instances, nodes, boxes, edge_index, rng):
        """Joint-bbox union point clouds with {1,2} membership channel
        (dataset_3dssg.py:324-356)."""
        e = len(edge_index)
        d = self.dim_pts
        rel_points = np.zeros((e, self.num_points_union, d + 1), np.float32)
        for k in range(e):
            i1, i2 = nodes[edge_index[k, 0]], nodes[edge_index[k, 1]]
            lo = np.minimum(boxes[i1][0], boxes[i2][0])
            hi = np.maximum(boxes[i1][1], boxes[i2][1])
            inside = np.all((points[:, :3] > lo) & (points[:, :3] < hi), axis=-1)
            sel = np.nonzero(inside)[0]
            if len(sel) == 0:
                continue
            choice = rng.choice(len(sel), self.num_points_union, replace=True)
            idx = sel[choice]
            ps = points[idx].astype(np.float32)
            mask = (instances[idx] == i1) * 1 + (instances[idx] == i2) * 2
            ps[:, :3] -= ps[:, :3].mean(0, keepdims=True)
            rel_points[k, :, :d] = ps
            rel_points[k, :, d] = mask
        return rel_points


class SceneLoader:
    """Bucketing batch iterator over SSGScenes.

    Training: shuffled scan order per epoch (seeded), scenes without any GT
    relation replaced by a random other scene; each batch padded to the
    smallest bucket that fits its largest scene.  Validation: sequential,
    unshuffled, one scene per batch (reference model.py:182-190).
    """

    def __init__(self, scenes: SSGScenes, batch_size: int, shuffle: bool,
                 seed: int = 2020, buckets: Sequence[int] | None = None,
                 drop_last: bool = False, for_train: bool = False):
        self.scenes = scenes
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.buckets = tuple(buckets) if buckets else None
        self.drop_last = drop_last
        self.for_train = for_train
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.scenes)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[SceneBatch]:
        rng = np.random.RandomState(self.seed + self.epoch)
        order = np.arange(len(self.scenes))
        if self.shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                break
            prepared = []
            rel_start = 0 if self.scenes.multi_rel else 1  # skip 'none' col
            for i in idxs:
                s = self.scenes.prepare(int(i), rng)
                while self.for_train and (
                    len(s["edge_index"]) == 0
                    or s["gt_rels"][:, rel_start:].sum() == 0
                ):
                    s = self.scenes.prepare(int(rng.randint(len(self.scenes))), rng)
                prepared.append(s)
            n_max = max(p["obj_points"].shape[0] for p in prepared)
            bucket = pick_bucket(n_max, self.buckets) if self.buckets else pick_bucket(n_max)
            with_text = "rel_text_feat" in prepared[0]
            padded = [
                pad_scene(
                    p["obj_points"], p["descriptor"], p["obj_2d_feats"], p["gt_class"],
                    p["edge_index"], p["gt_rels"], n_max=bucket,
                    rel_text_feat=p.get("rel_text_feat"),
                    rel_points=p.get("rel_points"),
                    feat_dim=self.scenes.feat_dim,
                )
                for p in prepared
            ]
            yield collate(padded, with_text=with_text)
        self.epoch += 1
