"""Synthetic labelled scenes and on-disk splits for tests and the smoke run
(counterpart of ``vlsat_tpu/data/synthetic.py``).

Scenes have clustered point sets per instance, the full directed edge set
and sparse multi-hot predicates (and, with ``with_text``, unit-norm per-edge
text targets for the rel-mimic loss); the numpy draws are those of the JAX
package for the same seed, and the descriptor comes from the port's
``gen_descriptor``.  ``make_synthetic_split`` writes a 3DSSG-style split to
disk (relationships JSON, class lists, PLY scans or npz mesh caches) for
``data.dataset.SSGScenes``; its files equal the JAX package's for the same
arguments.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from vlsat_tpu_torch.ops.descriptor import gen_descriptor
from vlsat_tpu_torch.scene import (NUM_OBJ_CLASSES, NUM_REL_CLASSES, SceneBatch, collate,
                                   full_edge_index, pad_scene, pick_bucket)
_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets", "3dssg")


def make_scene(rng: np.random.RandomState, num_nodes: int, num_points: int = 128,
               feat_dim: int = 512, num_obj_classes: int = NUM_OBJ_CLASSES,
               num_rel_classes: int = NUM_REL_CLASSES, rel_density: float = 0.08) -> dict:
    """One unpadded scene of host arrays (the ``pad_scene`` fields)."""
    centers = rng.randn(num_nodes, 1, 3).astype(np.float32) * 2.0
    scales = 0.2 + rng.rand(num_nodes, 1, 3).astype(np.float32)
    pts = centers + rng.randn(num_nodes, num_points, 3).astype(np.float32) * scales
    desc = gen_descriptor(torch.from_numpy(pts)).numpy()
    ei = full_edge_index(num_nodes)
    gt_rels = (rng.rand(len(ei), num_rel_classes) < rel_density).astype(np.float32)
    return dict(
        obj_points=pts - pts.mean(axis=1, keepdims=True),
        descriptor=desc,
        obj_2d_feats=rng.randn(num_nodes, feat_dim).astype(np.float32),
        gt_class=rng.randint(0, num_obj_classes, num_nodes).astype(np.int32),
        edge_index=ei,
        gt_rels=gt_rels,
    )


def validation_scene_stats(num_scans: int, seed: int = 0) -> tuple:
    """(node_counts, rel_counts) of ``num_scans`` scenes drawn jointly, with
    replacement, from the real 3DSSG validation split
    (assets/3dssg/relationships_validation.json: N in 5..9 per scan-split),
    which keeps its bucket mix and label density."""
    with open(os.path.join(_ASSETS, "relationships_validation.json")) as f:
        scans = json.load(f)["scans"]
    real = [(len(s["objects"]), len(s["relationships"])) for s in scans]
    rng = np.random.RandomState(seed)
    picks = [real[i] for i in rng.randint(0, len(real), num_scans)]
    return [n for n, _ in picks], [r for _, r in picks]


def make_synthetic_split(base_dir: str, num_scans: int = 64, insts_per_scan=(9, 16),
                         vertices_per_inst: int = 600, rels_per_scan=12, seed: int = 0,
                         split: str = "validation", node_counts=None, rel_counts=None,
                         write_ply: bool = False, background_verts: int = 0) -> tuple:
    """Fabricate a 3DSSG-style split on disk; returns (root, scans_root,
    cache_root).  Mesh tensors go straight into the loader's npz cache, or,
    with ``write_ply``, into real binary PLYs under
    ``scans_root/{scan}/labels.instances.align.annotated.v2.ply`` with the
    cache left empty (the cold path, PLY parse included).

    ``node_counts`` / ``rel_counts``: explicit per-scan instance and
    relation counts (``validation_scene_stats`` gives the real 3DSSG
    validation histogram); otherwise uniform draws from ``insts_per_scan``
    and ``rels_per_scan`` (an int, or a (lo, hi) tuple).
    ``background_verts``: extra instance-0 (unannotated) vertices per scan,
    as real 3RScan meshes carry unlabelled clutter.  Reuses an existing
    build of the same parameters."""
    from vlsat_tpu_torch.data.ply import write_ply_vertices

    root = os.path.join(base_dir, "3dssg")
    scans_root = os.path.join(base_dir, "scans")
    cache_root = os.path.join(base_dir, "cache")
    stamp = os.path.join(base_dir, "stamp.json")
    params = dict(num_scans=num_scans, insts=list(insts_per_scan),
                  verts=vertices_per_inst,
                  rels=list(rels_per_scan) if isinstance(
                      rels_per_scan, (tuple, list)) else rels_per_scan,
                  seed=seed, split=split,
                  nodes=(list(map(int, node_counts)) if node_counts is not None else None),
                  rel_counts=(list(map(int, rel_counts)) if rel_counts is not None else None),
                  ply=bool(write_ply), bg=int(background_verts))
    if os.path.exists(stamp):
        with open(stamp) as f:
            if json.load(f) == params:
                return root, scans_root, cache_root
    for d in (root, scans_root, cache_root):
        os.makedirs(d, exist_ok=True)
    for name in ("classes.txt", "relationships.txt", "relations.txt"):
        with open(os.path.join(_ASSETS, name)) as src, \
                open(os.path.join(root, name), "w") as dst:
            dst.write(src.read())
    with open(os.path.join(root, "classes.txt")) as f:
        classes = [l.strip() for l in f if l.strip()]
    with open(os.path.join(root, "relationships.txt")) as f:
        rel_names = [l.strip() for l in f if l.strip()]

    rng = np.random.RandomState(seed)
    lo, hi = insts_per_scan
    for name, counts in (("node_counts", node_counts), ("rel_counts", rel_counts)):
        if counts is not None and len(counts) != num_scans:
            raise ValueError(f"{name} has {len(counts)} entries for {num_scans} scans")
    scan_ids = [f"synth{i:04d}-scan" for i in range(num_scans)]
    scenes = []
    for si, scan in enumerate(scan_ids):
        n = (int(node_counts[si]) if node_counts is not None
             else int(rng.randint(lo, hi + 1)))
        pts, inst = [], []
        for iid in range(1, n + 1):
            c = rng.randn(3).astype(np.float32) * 2.5
            pts.append(c + rng.randn(vertices_per_inst, 3).astype(np.float32)
                       * (0.2 + rng.rand(3).astype(np.float32)))
            inst.append(np.full(vertices_per_inst, iid, np.int32))
        if background_verts:
            # its own stream: the clutter must not shift the main draws
            bg_rng = np.random.RandomState((seed + 991 * si) % (2**31 - 1))
            pts.append(bg_rng.randn(background_verts, 3).astype(np.float32) * 5)
            inst.append(np.zeros(background_verts, np.int32))
        all_pts = np.concatenate(pts).astype(np.float32)
        all_inst = np.concatenate(inst)
        if write_ply:
            d = os.path.join(scans_root, scan)
            os.makedirs(d, exist_ok=True)
            write_ply_vertices(os.path.join(d, "labels.instances.align.annotated.v2.ply"),
                               all_pts, instances=all_inst.astype(np.int32))
        else:
            np.savez(os.path.join(cache_root, f"{scan}.npz"), points=all_pts,
                     instances=all_inst)
        objects = {str(i): classes[int(rng.randint(len(classes)))] for i in range(1, n + 1)}
        if rel_counts is not None:
            n_rels = int(rel_counts[si])
        elif isinstance(rels_per_scan, (tuple, list)):
            r_lo, r_hi = rels_per_scan
            n_rels = int(rng.randint(r_lo, r_hi + 1))
        else:
            n_rels = int(rels_per_scan)
        rels = []
        for _ in range(n_rels):
            a, b = rng.choice(np.arange(1, n + 1), 2, replace=False)
            r = int(rng.randint(1, len(rel_names)))  # skip 'none'
            rels.append([int(a), int(b), r, rel_names[r]])
        scenes.append({"scan": scan, "split": 1, "objects": objects, "relationships": rels})

    for s in ("train", "validation"):
        with open(os.path.join(root, f"relationships_{s}.json"), "w") as f:
            json.dump({"scans": scenes}, f)
        with open(os.path.join(root, f"{s}_scans.txt"), "w") as f:
            f.write("\n".join(scan_ids))
    with open(stamp, "w") as f:
        json.dump(params, f)
    return root, scans_root, cache_root


def edge_text_targets(rng: np.random.RandomState, num_edges: int,
                      feat_dim: int = 512) -> np.ndarray:
    """(num_edges, feat_dim) unit-norm stand-ins for the CLIP text embeddings
    of each edge's GT triplet sentence (synthetic.py:221-224)."""
    t = rng.randn(num_edges, feat_dim).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def make_batch(seed: int = 0, node_counts=(5, 9), num_points: int = 128,
               bucket: int | None = None, feat_dim: int = 512, with_text: bool = False,
               **kw) -> SceneBatch:
    """A host SceneBatch of ``make_scene`` scenes padded to ``bucket`` (by
    default the bucket of the largest scene); ``with_text`` adds
    ``rel_text_feat`` targets of ``feat_dim`` channels."""
    rng = np.random.RandomState(seed)
    n_max = bucket or pick_bucket(max(node_counts))
    scenes = []
    for n in node_counts:
        s = make_scene(rng, n, num_points=num_points, feat_dim=feat_dim, **kw)
        text = edge_text_targets(rng, len(s["edge_index"]), feat_dim) if with_text else None
        scenes.append(pad_scene(s["obj_points"], s["descriptor"], s["obj_2d_feats"],
                                s["gt_class"], s["edge_index"], s["gt_rels"], n_max=n_max,
                                rel_text_feat=text, feat_dim=feat_dim))
    return collate(scenes, with_text=with_text)
