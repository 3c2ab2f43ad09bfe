"""Scenes of the benchmark's traffic, made in memory from the seed.

Labels are real: the objects (160 classes) and relationships (26
predicates, multi-label) of the 3DSSG validation split (548 scan-splits of
5-9 objects, from 157 scans).  The benchmark keeps its own copy of the
split's files in ``harness/assets`` (``relationships_validation.json``,
``classes.txt``, ``relationships.txt``, as the repository's
``assets/3dssg`` holds them), so that its traffic does not move with the
program's data.  Two sources read it:

* ``val_splits``: the 548 scan-splits as they are (the evaluation unit of
  the paper and of ``main --eval``);
* ``val_scans``: each scan whole, the union of its splits' objects and
  relationships (5-81 objects), leaving out scans above ``max_nodes``.

Points are synthetic, drawn as the program's ``data/synthetic.make_scene``
draws them (a Gaussian cloud per instance around a random centre with a
random per-axis scale), ``num_points`` per instance; the descriptor is that
of ``ops/descriptor.gen_descriptor`` over the raw cloud, computed here in
numpy; the cloud is zero-meaned and rounded to float16-representable
values, so that a float16 wire carries it exactly.  The 2D features are
standard normal.  Every scene carries its full directed graph.

A seed changes the points and the order of the scenes, never which scenes
(node and relation counts) make up a pool.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ASSETS = Path(__file__).resolve().parent / "assets"


def _lines(name: str) -> List[str]:
    with open(ASSETS / name) as f:
        return [line.strip() for line in f if line.strip()]


def _splits() -> list:
    with open(ASSETS / "relationships_validation.json") as f:
        return json.load(f)["scans"]


def label_specs(source: str, max_nodes: Optional[int] = None) -> List[dict]:
    """Per scene: ``scan``, ``gt_class`` (n,) int32 and ``rels``, a list of
    (subject, object, predicate column) with local node indices; the
    predicate column indexes ``relationships.txt`` without its leading
    "none"."""
    classes = {c: i for i, c in enumerate(_lines("classes.txt"))}
    num_rel = len(_lines("relationships.txt")) - 1
    splits = _splits()
    if source == "val_splits":
        groups = [(s["scan"], [s]) for s in splits]
    elif source == "val_scans":
        by_scan: Dict[str, list] = {}
        for s in splits:
            by_scan.setdefault(s["scan"], []).append(s)
        groups = list(by_scan.items())
    else:
        raise ValueError(f"unknown scene source {source!r}")
    specs = []
    for scan, parts in groups:
        objects: Dict[str, str] = {}
        rels = set()
        for p in parts:
            objects.update(p["objects"])
            rels.update((int(r[0]), int(r[1]), int(r[2])) for r in p["relationships"])
        if max_nodes is not None and len(objects) > max_nodes:
            continue
        local = {int(k): i for i, k in enumerate(objects)}
        edges = sorted((local[s], local[o], r - 1) for s, o, r in rels
                       if s in local and o in local and s != o and 1 <= r <= num_rel)
        specs.append({"scan": scan,
                      "gt_class": np.array([classes[c] for c in objects.values()], np.int32),
                      "rels": edges})
    return specs


def full_edge_index(n: int) -> np.ndarray:
    """All ordered (i, j) pairs, i != j, subject-major: (n(n-1), 2) int32."""
    idx = np.arange(n)
    src, dst = np.repeat(idx, n), np.tile(idx, n)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=-1).astype(np.int32)


def descriptor(pts: np.ndarray) -> np.ndarray:
    """(..., P, 3) -> (..., 11): centroid, std (ddof 1), bbox dims, volume,
    longest side."""
    centroid = pts.mean(axis=-2)
    std = np.sqrt(np.square(pts - centroid[..., None, :]).sum(axis=-2) / (pts.shape[-2] - 1))
    dims = pts.max(axis=-2) - pts.min(axis=-2)
    volume = np.prod(dims, axis=-1, keepdims=True)
    length = dims.max(axis=-1, keepdims=True)
    return np.concatenate([centroid, std, dims, volume, length], axis=-1).astype(np.float32)


def make_scenes(specs: List[dict], seed: int, num_points: int = 128, feat_dim: int = 512,
                num_rel: int = 26, with_2d: bool = True) -> List[dict]:
    """One scene dict per spec (the fields of the program's ``pad_scene``:
    ``obj_points`` (n, P, 3), ``descriptor`` (n, 11), ``obj_2d_feats``
    (n, feat_dim), ``gt_class``, ``edge_index`` (e, 2), ``gt_rels`` (e, R)),
    drawn in a few large calls from ``seed``."""
    rng = np.random.Generator(np.random.PCG64(seed))
    counts = [len(s["gt_class"]) for s in specs]
    total = int(sum(counts))
    centers = rng.standard_normal((total, 1, 3), np.float32) * 2.0
    scales = 0.2 + rng.random((total, 1, 3), np.float32)
    pts = centers + rng.standard_normal((total, num_points, 3), np.float32) * scales
    desc = descriptor(pts)
    pts = (pts - pts.mean(axis=1, keepdims=True)).astype(np.float16).astype(np.float32)
    feats = (rng.standard_normal((total, feat_dim), np.float32) if with_2d
             else np.zeros((total, feat_dim), np.float32))
    out, at = [], 0
    for spec, n in zip(specs, counts):
        ei = full_edge_index(n)
        gt = np.zeros((len(ei), num_rel), np.float32)
        for s, o, r in spec["rels"]:
            gt[s * (n - 1) + (o if o < s else o - 1), r] = 1.0
        out.append({"obj_points": pts[at:at + n], "descriptor": desc[at:at + n],
                    "obj_2d_feats": feats[at:at + n], "gt_class": spec["gt_class"],
                    "edge_index": ei, "gt_rels": gt})
        at += n
    return out


def order(count: int, seed: int, salt: int = 0) -> np.ndarray:
    """A permutation of ``count`` items from ``seed`` (``salt`` gives
    independent streams)."""
    return np.random.Generator(np.random.PCG64([seed, salt])).permutation(count)
