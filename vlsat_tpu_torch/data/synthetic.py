"""Synthetic labelled scenes for tests and the smoke run (counterpart of
``vlsat_tpu/data/synthetic.py:26-70,207-232``).

Scenes have clustered point sets per instance, the full directed edge set
and sparse multi-hot predicates (and, with ``with_text``, unit-norm per-edge
text targets for the rel-mimic loss); the numpy draws are those of the JAX
package for the same seed, and the descriptor comes from the port's
``gen_descriptor``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from vlsat_tpu_torch.ops.descriptor import gen_descriptor
from vlsat_tpu_torch.scene import SceneBatch, collate, full_edge_index, pad_scene, pick_bucket

NUM_OBJ_CLASSES = 160
NUM_REL_CLASSES = 26
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
