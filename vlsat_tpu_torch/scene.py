"""Fixed-shape scene-graph batch of torch tensors.

Counterpart of ``vlsat_tpu/scene.py``: the problem sizes (:29-31),
``SceneBatch`` (:60-117) with the same fields, shapes and dtypes, and the
host helpers ``pick_bucket``, ``full_edge_index`` (:42-55), ``pad_scene``
with ``_SAFE_DESCRIPTOR`` (:120-171), ``pad_batch_scenes`` (:174-211, host
batches only) and ``collate`` (:214-240).  Scenes are padded to a node bucket;
padded entries are sanitized so that downstream ``log``/``norm`` calls stay
finite, and the masks carry validity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# Default problem sizes of the 3DSSG benchmark.
NUM_OBJ_CLASSES = 160
NUM_REL_CLASSES = 26
DESCRIPTOR_DIM = 11

# Node-count buckets; E is always N*(N-1).
DEFAULT_NODE_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64)


def edge_count(num_nodes: int) -> int:
    return num_nodes * (num_nodes - 1)


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_NODE_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def full_edge_index(num_nodes: int) -> np.ndarray:
    """All ordered (i, j) pairs, i != j: shape (N*(N-1), 2) int32."""
    idx = np.arange(num_nodes)
    src = np.repeat(idx, num_nodes)
    dst = np.tile(idx, num_nodes)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SceneBatch:
    """A batch of padded scene graphs (B scenes, N nodes, E edges, P points
    per node, C point channels, R relation classes):

      obj_points    (B, N, P, C) float   instance points, xyz zero-meaned
      obj_mask      (B, N)       bool    node validity
      descriptor    (B, N, 11)   float   raw-point descriptor
      obj_2d_feats  (B, N, D2)   float   per-instance CLIP features
      gt_class      (B, N)       int32   object class id (0 on padding)
      edge_index    (B, E, 2)    int32   (subject, object); (0, 0) on padding
      edge_mask     (B, E)       bool    edge validity
      gt_rels       (B, E, R)    float   multi-hot predicate labels
      rel_text_feat (B, E, D2)   float   optional per-edge text target
      rel_points    (B, E, Pu, 4) float  optional union point clouds
      rel_text_idx  (B, E)       int32   optional rows of a text table
    """

    obj_points: torch.Tensor
    obj_mask: torch.Tensor
    descriptor: torch.Tensor
    obj_2d_feats: torch.Tensor
    gt_class: torch.Tensor
    edge_index: torch.Tensor
    edge_mask: torch.Tensor
    gt_rels: torch.Tensor
    rel_text_feat: Optional[torch.Tensor] = None
    rel_points: Optional[torch.Tensor] = None
    rel_text_idx: Optional[torch.Tensor] = None

    @property
    def num_scenes(self) -> int:
        return self.obj_points.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.obj_points.shape[1]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    def replace(self, **kw) -> "SceneBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device, non_blocking: bool = False) -> "SceneBatch":
        return SceneBatch(**{
            f.name: (None if getattr(self, f.name) is None else
                     getattr(self, f.name).to(device, non_blocking=non_blocking))
            for f in dataclasses.fields(self)})


# Descriptor of a padded node: zero centroid/std, unit dims/volume/length, so
# the log-ratios of the edge descriptor and the log features are exactly 0.
_SAFE_DESCRIPTOR = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1], np.float32)


def pad_scene(obj_points: np.ndarray, descriptor: np.ndarray,
              obj_2d_feats: np.ndarray, gt_class: np.ndarray,
              edge_index: np.ndarray, gt_rels: np.ndarray, n_max: int,
              rel_text_feat: Optional[np.ndarray] = None,
              rel_points: Optional[np.ndarray] = None,
              feat_dim: int = 512) -> dict:
    """Pad one scene's host arrays to (n_max, ...) / (edge_count(n_max), ...)."""
    n = obj_points.shape[0]
    e = edge_index.shape[0]
    e_max = edge_count(n_max)
    if n > n_max:
        raise ValueError(f"scene has {n} nodes > bucket {n_max}")
    if e > e_max:
        raise ValueError(f"scene has {e} edges > {e_max} at bucket {n_max}")
    p, c = obj_points.shape[1], obj_points.shape[2]
    out = {
        "obj_points": np.zeros((n_max, p, c), np.float32),
        "obj_mask": np.zeros((n_max,), bool),
        "descriptor": np.tile(_SAFE_DESCRIPTOR, (n_max, 1)),
        "obj_2d_feats": np.zeros(
            (n_max, obj_2d_feats.shape[-1] if obj_2d_feats.size else feat_dim), np.float32),
        "gt_class": np.zeros((n_max,), np.int32),
        "edge_index": np.zeros((e_max, 2), np.int32),
        "edge_mask": np.zeros((e_max,), bool),
        "gt_rels": np.zeros((e_max, gt_rels.shape[-1]), np.float32),
    }
    out["obj_points"][:n] = obj_points
    out["obj_mask"][:n] = True
    out["descriptor"][:n] = descriptor
    out["obj_2d_feats"][:n] = obj_2d_feats
    out["gt_class"][:n] = gt_class
    out["edge_index"][:e] = edge_index
    out["edge_mask"][:e] = True
    out["gt_rels"][:e] = gt_rels
    if rel_text_feat is not None:
        buf = np.zeros((e_max, rel_text_feat.shape[-1]), np.float32)
        buf[:e] = rel_text_feat
        out["rel_text_feat"] = buf
    if rel_points is not None:
        buf = np.zeros((e_max, *rel_points.shape[1:]), np.float32)
        buf[:e] = rel_points
        out["rel_points"] = buf
    return out


def pad_batch_scenes(batch: SceneBatch, total: int) -> SceneBatch:
    """Grow a host SceneBatch to ``total`` scenes by appending fully-masked
    pad scenes (all-False obj/edge masks, ``_SAFE_DESCRIPTOR`` descriptors so
    that downstream logs stay finite).  Pad scenes contribute nothing to
    losses or metrics; the grouped resident eval pads its tail batch so."""
    b = batch.num_scenes
    if total < b:
        raise ValueError(f"total {total} < batch scenes {b}")
    if total == b:
        return batch
    k = total - b

    def pad(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is None:
            return None
        return torch.cat([x, x.new_zeros((k, *x.shape[1:]))])

    desc = torch.from_numpy(np.tile(_SAFE_DESCRIPTOR, (k, batch.num_nodes, 1)))
    kw = {f.name: pad(getattr(batch, f.name)) for f in dataclasses.fields(batch)}
    kw["descriptor"] = torch.cat([batch.descriptor, desc.to(batch.descriptor)])
    return SceneBatch(**kw)


def collate(scenes: Sequence[dict], with_text: bool = False,
            device: torch.device | str = "cpu") -> SceneBatch:
    """Stack per-scene padded dicts (all of one bucket) into a SceneBatch of
    tensors on ``device`` (the host by default, where the wire encode runs)."""
    stack = lambda k: torch.from_numpy(np.stack([s[k] for s in scenes])).to(device)
    rel_text = None
    if with_text and "rel_text_feat" in scenes[0]:
        rel_text = stack("rel_text_feat")
    rel_points = stack("rel_points") if "rel_points" in scenes[0] else None
    return SceneBatch(
        obj_points=stack("obj_points"),
        obj_mask=stack("obj_mask"),
        descriptor=stack("descriptor"),
        obj_2d_feats=stack("obj_2d_feats"),
        gt_class=stack("gt_class"),
        edge_index=stack("edge_index"),
        edge_mask=stack("edge_mask"),
        gt_rels=stack("gt_rels"),
        rel_text_feat=rel_text,
        rel_points=rel_points,
    )
