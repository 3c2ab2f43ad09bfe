"""Packed per-bucket tensor cache (counterpart of ``vlsat_tpu/data/packed.py``).

Scenes are prepared once (``SSGScenes.prepare``), padded to their node-count
bucket and stored as one contiguous array per (variant, bucket, field); the
loader memory-maps them, so a batch is an array slice: no sampling, padding
or stacking at iteration time.  The on-disk format is the JAX package's, byte
for byte (format 2: ``manifest.json``, ``v{variant}_b{bucket}_{field}.npy``
and the deduplicated ``text_table.npy``), so a pack that either package
wrote is read by the other.

A pack freezes one point draw per variant; ``pack_scenes(variants=k)`` packs
k independent draws and the loader cycles one variant per epoch, which keeps
epoch-to-epoch sampling diversity at k times the disk.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlsat_tpu_torch.data.bucket_batch import resolve_batch
from vlsat_tpu_torch.scene import (
    DEFAULT_NODE_BUCKETS, SceneBatch, edge_count, pad_scene, pick_bucket)

_FIELDS = ("obj_points", "obj_mask", "descriptor", "obj_2d_feats",
           "gt_class", "edge_index", "edge_mask", "gt_rels")
_OPT_FIELDS = ("rel_text_idx", "rel_points")


class _TextDedup:
    """Exact byte-level dedup of per-edge text-target vectors: the target
    depends only on (subject class, object class, GT-rel set), so a split
    has a few thousand distinct rows.  Row 0 is the zero vector (padded
    edges)."""

    def __init__(self):
        self._index: Dict[bytes, int] = {}
        self.rows: List[np.ndarray] = []
        self.dim: Optional[int] = None

    def indices(self, feats: np.ndarray) -> np.ndarray:
        self.dim = feats.shape[-1]
        out = np.zeros((len(feats),), np.int32)
        for i, row in enumerate(np.ascontiguousarray(feats, np.float32)):
            key = row.tobytes()
            idx = self._index.get(key)
            if idx is None:
                idx = len(self.rows) + 1  # 0 is reserved for the zero row
                self._index[key] = idx
                self.rows.append(row)
            out[i] = idx
        return out

    def table(self) -> np.ndarray:
        dim = self.dim or 512
        return np.concatenate(
            [np.zeros((1, dim), np.float32),
             np.stack(self.rows) if self.rows else np.zeros((0, dim), np.float32)])


def _scene_seed(seed: int, variant: int, i: int) -> int:
    """Deterministic per-(variant, scene) RNG seed, independent of the order
    scenes are prepared in: a parallel pack reproduces a serial one."""
    return int(seed + 1000 * variant + 97003 * (i + 1)) % (2**31 - 1)


_WORKER_SCENES = None


def _pack_worker_init(factory):
    global _WORKER_SCENES
    _WORKER_SCENES = factory()


def _pack_worker_prepare(task):
    i, s = task
    return i, _WORKER_SCENES.prepare(i, np.random.RandomState(s))


def build_scenes(kwargs: dict):
    """Picklable ``SSGScenes`` factory for ``pack_scenes(workers=...)``."""
    from vlsat_tpu_torch.data.dataset import SSGScenes

    return SSGScenes(**kwargs)


def pack_scenes(scenes, out_dir: str, buckets: Sequence[int] = DEFAULT_NODE_BUCKETS,
                seed: int = 2020, variants: int = 1, drop_relation_free: bool = False,
                workers: int = 0, scenes_factory=None, per_scene_seed: bool = False) -> dict:
    """Prepare and pad every scene of an ``SSGScenes`` split and store the
    per-bucket stacked arrays under ``out_dir``.  Returns the manifest (also
    written to ``manifest.json``).

    ``variants``: independent point-sampling draws to pack (the loader
    cycles them).  ``drop_relation_free``: leave out scenes without any GT
    relation (the reference resamples them away in training).

    ``workers > 0`` prepares the scenes (PLY parse, point sampling,
    descriptors) in a ``spawn`` process pool; it needs ``scenes_factory``,
    a picklable zero-argument callable that builds the split in each worker
    (e.g. ``functools.partial(build_scenes, kwargs)``).  Parallel packs seed
    each scene on its own (``_scene_seed``), so the output does not depend
    on the worker count; ``per_scene_seed=True`` applies the same seeding
    serially.  The default serial path draws every scene from one shared
    RandomState stream."""
    if workers > 0 and scenes_factory is None:
        raise ValueError("pack_scenes(workers>0) requires scenes_factory")
    os.makedirs(out_dir, exist_ok=True)
    rel_start = 0 if scenes.multi_rel else 1
    manifest = {
        "format": 2,  # 2: rel-mimic targets as text_table + rel_text_idx
        "buckets": {}, "seed": seed, "variants": variants,
        "scan_ids": [s.scan_id for s in scenes.index.scenes],
        "feat_dim": scenes.feat_dim,
        "num_points": scenes.num_points,
        "multi_rel": scenes.multi_rel,
        "w_cls_obj": np.asarray(scenes.w_cls_obj, np.float64).tolist(),
        "w_cls_rel": np.asarray(scenes.w_cls_rel, np.float64).tolist(),
    }
    dedup = _TextDedup()  # shared across variants: targets are label-derived

    def _prepared_stream(v):
        if workers > 0:
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            tasks = [(i, _scene_seed(seed, v, i)) for i in range(len(scenes))]
            with ctx.Pool(workers, initializer=_pack_worker_init,
                          initargs=(scenes_factory,)) as pool:
                yield from pool.imap(_pack_worker_prepare, tasks, chunksize=8)
        elif per_scene_seed:
            for i in range(len(scenes)):
                yield i, scenes.prepare(i, np.random.RandomState(_scene_seed(seed, v, i)))
        else:
            rng = np.random.RandomState(seed + 1000 * v)
            for i in range(len(scenes)):
                yield i, scenes.prepare(i, rng)

    for v in range(variants):
        groups: Dict[int, List[Tuple[int, dict]]] = {}
        for i, s in _prepared_stream(v):
            if drop_relation_free and (
                    len(s["edge_index"]) == 0 or s["gt_rels"][:, rel_start:].sum() == 0):
                continue
            b = pick_bucket(s["obj_points"].shape[0], buckets)
            text = s.get("rel_text_feat")
            padded = pad_scene(
                s["obj_points"], s["descriptor"], s["obj_2d_feats"], s["gt_class"],
                s["edge_index"], s["gt_rels"], n_max=b, rel_points=s.get("rel_points"),
                feat_dim=scenes.feat_dim)
            if text is not None:
                idx = np.zeros((edge_count(b),), np.int32)
                idx[:len(text)] = dedup.indices(text)
                padded["rel_text_idx"] = idx
            groups.setdefault(b, []).append((i, padded))
        for b, items in sorted(groups.items()):
            idxs = [i for i, _ in items]
            fields = list(_FIELDS) + [f for f in _OPT_FIELDS if f in items[0][1]]
            for f in fields:
                np.save(os.path.join(out_dir, f"v{v}_b{b}_{f}.npy"),
                        np.stack([p[f] for _, p in items]))
            if v == 0:
                manifest["buckets"][str(b)] = {"count": len(items), "scene_indices": idxs,
                                               "fields": fields}
            elif manifest["buckets"][str(b)]["scene_indices"] != idxs:
                # node sets do not depend on the draw, only the points do
                raise RuntimeError(f"variant {v} grouped bucket {b} differently")

    if dedup.rows:
        np.save(os.path.join(out_dir, "text_table.npy"), dedup.table())
        manifest["text_table"] = "text_table.npy"
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


class PackedScenes:
    """Memory-mapped access to a packed split."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format", 1) != 2:
            raise ValueError(
                f"{root}: pack format {self.manifest.get('format', 1)} is older than "
                "this loader; rebuild it with pack_scenes")
        self.buckets = sorted(int(b) for b in self.manifest["buckets"])
        self.variants = int(self.manifest.get("variants", 1))
        self.w_cls_obj = np.asarray(self.manifest["w_cls_obj"], np.float32)
        self.w_cls_rel = np.asarray(self.manifest["w_cls_rel"], np.float32)
        self._arrays: Dict[Tuple[int, int, str], np.ndarray] = {}
        self._max_gt: Optional[int] = None
        # the deduplicated per-edge text-target table (rel-mimic loss): the
        # train step moves it to the device once and gathers rows by
        # batch.rel_text_idx
        self.text_table: Optional[np.ndarray] = None
        if "text_table" in self.manifest:
            self.text_table = np.load(os.path.join(root, self.manifest["text_table"]))

    def __len__(self) -> int:
        return sum(m["count"] for m in self.manifest["buckets"].values())

    @property
    def max_gt(self) -> int:
        """Largest per-edge GT-relation count across the split (every bucket
        and variant; >= 1): the evaluation engine ships only that many of
        the R sorted rank slots per edge."""
        if self._max_gt is None:
            m = 1
            for v in range(self.variants):
                for b in self.buckets:
                    gr = self.array(b, "gt_rels", v)
                    if gr.size:
                        m = max(m, int((np.asarray(gr) > 0).sum(axis=-1).max()))
            self._max_gt = m
        return self._max_gt

    def fields(self, bucket: int) -> List[str]:
        return self.manifest["buckets"][str(bucket)]["fields"]

    def count(self, bucket: int) -> int:
        return self.manifest["buckets"][str(bucket)]["count"]

    def array(self, bucket: int, field: str, variant: int = 0) -> np.ndarray:
        """The read-only memory map of one (variant, bucket, field) array."""
        key = (variant, bucket, field)
        if key not in self._arrays:
            self._arrays[key] = np.load(
                os.path.join(self.root, f"v{variant}_b{bucket}_{field}.npy"), mmap_mode="r")
        return self._arrays[key]

    def batch(self, bucket: int, idx, variant: int = 0) -> SceneBatch:
        """A host SceneBatch of rows ``idx`` (a slice or an index array) of
        one bucket: CPU tensors over private copies of the mapped rows
        (``torch.from_numpy`` of a read-only map would share and warn)."""
        fields = self.fields(bucket)
        get = lambda f: torch.from_numpy(np.array(self.array(bucket, f, variant)[idx]))
        return SceneBatch(
            obj_points=get("obj_points"), obj_mask=get("obj_mask"),
            descriptor=get("descriptor"), obj_2d_feats=get("obj_2d_feats"),
            gt_class=get("gt_class"), edge_index=get("edge_index"),
            edge_mask=get("edge_mask"), gt_rels=get("gt_rels"), rel_text_feat=None,
            rel_points=get("rel_points") if "rel_points" in fields else None,
            rel_text_idx=get("rel_text_idx") if "rel_text_idx" in fields else None)


class PackedLoader:
    """Batch iterator over a PackedScenes split.

    Shuffled epochs permute within each bucket (batches stay same-bucket);
    sequential epochs emit contiguous slices.  Each epoch advances the pack
    variant cyclically when more than one draw was packed.  ``batch_size``
    is an int or a {bucket: B} mapping (``data/bucket_batch.py``)."""

    def __init__(self, packed: PackedScenes, batch_size, shuffle: bool = False,
                 seed: int = 2020, drop_last: bool = False):
        self.packed = packed
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    @property
    def max_gt(self) -> int:
        """The evaluation engine's GT-slot cap (see ``PackedScenes.max_gt``)."""
        return self.packed.max_gt

    def __len__(self) -> int:
        n = 0
        for b in self.packed.buckets:
            c, bs = self.packed.count(b), resolve_batch(self.batch_size, b)
            n += c // bs if self.drop_last else -(-c // bs)
        return n

    def __iter__(self) -> Iterator[SceneBatch]:
        rng = np.random.RandomState(self.seed + self.epoch)
        variant = self.epoch % self.packed.variants
        for b in self.packed.buckets:
            c, bs = self.packed.count(b), resolve_batch(self.batch_size, b)
            order = rng.permutation(c) if self.shuffle else None
            for start in range(0, c, bs):
                stop = min(start + bs, c)
                if self.drop_last and stop - start < bs:
                    break
                idx = order[start:stop] if order is not None else slice(start, stop)
                yield self.packed.batch(b, idx, variant)
        self.epoch += 1
