"""The port's per-scene recall API (``scene_recall_topk``,
``tally_ranked_candidates``, ``tally_hits``), ``evaluate_topk`` and
``wire_nbytes`` against the JAX package's, on tests/test_recall.py's,
tests/test_surface_tails.py's and tests/test_wire.py's cases.

Recalls and ranks must be equal (``assert_allclose`` at its default rtol
1e-7 against the cube-materialising oracles, as tests/test_recall.py holds
JAX); byte counts exactly equal.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.test_recall import slow_rels_recall, slow_scene_recall
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.data.wire import wire_nbytes as jax_wire_nbytes
from vlsat_tpu.eval import metrics as JM
from vlsat_tpu.eval import recall as JR
from vlsat_tpu.scene import full_edge_index
from vlsat_tpu_torch.data.wire import encode_wire, wire_nbytes
from vlsat_tpu_torch.eval import metrics as PM
from vlsat_tpu_torch.eval import recall as PR
from vlsat_tpu_torch.scene import SceneBatch


def _scene(seed: int, n: int, c: int, nrel: int, density: float, scale: float = 1.0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, c).astype(np.float32) * scale
    gt_class = rng.randint(0, c, n)
    ei = full_edge_index(n)
    rel_probs = rng.rand(len(ei), nrel).astype(np.float32)
    gt_rels = (rng.rand(len(ei), nrel) < density).astype(np.float32)
    return logits, rel_probs, gt_rels, gt_class, ei


def _both(*args, **kw):
    return (PR.scene_recall_topk(*args, **kw), JR.scene_recall_topk(*args, **kw))


def test_scene_recall_matches_oracle_and_jax():
    logits, rel_probs, gt_rels, gt_class, ei = _scene(3, 6, 10, 5, 0.25, scale=2.0)
    topk = (5, 20, 50)
    got, want = _both(logits, rel_probs, gt_rels, gt_class, ei, topk=topk, topk_each=30,
                      num_rel_classes=5)
    np.testing.assert_allclose(got, slow_scene_recall(logits, rel_probs, gt_rels, gt_class, ei,
                                                      list(topk), 30))
    np.testing.assert_array_equal(got, want)


def test_scene_recall_per_class_matches_jax():
    logits, rel_probs, gt_rels, gt_class, ei = _scene(4, 5, 8, 4, 0.3)
    got, want = _both(logits, rel_probs, gt_rels, gt_class, ei, topk=(10, 20), topk_each=20,
                      num_rel_classes=4, per_class=True)
    assert got.shape == (4, 2)
    for r in range(4):
        if (gt_rels[:, r] > 0).sum() == 0:
            assert (got[r] == -1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("topk_each", [1, 100])
def test_scene_recall_rels_mode_matches_oracle_and_jax(topk_each):
    logits, rel_probs, gt_rels, gt_class, ei = _scene(7, 6, 10, 5, 0.3)
    got, want = _both(logits, rel_probs, gt_rels, gt_class, ei, topk=(5, 20),
                      topk_each=topk_each, num_rel_classes=5, evaluate="rels")
    np.testing.assert_allclose(got, slow_rels_recall(rel_probs, gt_rels, [5, 20], topk_each))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["triplet", "rels"])
def test_scene_recall_valid_edges_ignores_padding(mode):
    logits, rel_v, gt_v, gt_class, ei_valid = _scene(9, 5, 8, 4, 0.3)
    ev, pad = len(ei_valid), 10
    ei = np.concatenate([ei_valid, np.zeros((pad, 2), np.int32)])
    rel_probs = np.concatenate([rel_v, np.full((pad, 4), 0.99, np.float32)])  # poisoned
    gt_rels = np.concatenate([gt_v, np.zeros((pad, 4), np.float32)])
    kw = dict(topk=(5, 20), topk_each=10, num_rel_classes=4, evaluate=mode)
    got, want = _both(logits, rel_probs, gt_rels, gt_class, ei, valid_edges=ev, **kw)
    np.testing.assert_array_equal(got, PR.scene_recall_topk(logits, rel_v, gt_v, gt_class,
                                                            ei_valid, **kw))
    np.testing.assert_array_equal(got, want)


def test_batched_hits_and_tally_equal_the_per_scene_api():
    """tests/test_recall.py:146-191: the engine's device pass
    (``batched_scene_hits``) tallied per scene by ``tally_hits`` equals
    ``scene_recall_topk`` (scalar and per-class, ``return_both``) for every
    (mode, gc/ngc) combination, ragged padded scenes, both packages."""
    rng = np.random.RandomState(11)
    b, n_max, c, nrel = 3, 6, 10, 5
    e_max = n_max * (n_max - 1)
    node_counts = [6, 4, 5]
    logits = rng.randn(b, n_max, c).astype(np.float32) * 2
    gt_class = rng.randint(0, c, (b, n_max)).astype(np.int32)
    rel_probs = rng.rand(b, e_max, nrel).astype(np.float32)
    edge_index = np.zeros((b, e_max, 2), np.int32)
    edge_mask = np.zeros((b, e_max), bool)
    gt_rels = np.zeros((b, e_max, nrel), np.float32)
    for s, nn in enumerate(node_counts):
        ei = full_edge_index(nn)
        edge_index[s, :len(ei)] = ei
        edge_mask[s, :len(ei)] = True
        gt_rels[s, :len(ei)] = rng.rand(len(ei), nrel) < 0.3
        rel_probs[s, len(ei):] = 0.99
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    for mode, te in (("triplet", 1), ("triplet", 100), ("rels", 1), ("rels", 100)):
        eg, hit = PR.batched_scene_hits(T(logits), T(rel_probs), T(edge_index), T(edge_mask),
                                        T(gt_class), T(gt_rels), topk_each=te, kmax=100,
                                        mode=mode)
        eg, hit = eg.numpy(), hit.numpy()
        for s, nn in enumerate(node_counts):
            ev = len(full_edge_index(nn))
            kw = dict(topk=(5, 20, 100), num_rel_classes=nrel)
            got = PR.tally_hits(eg[s], hit[s], gt_rels[s, :ev], **kw)
            want = JR.tally_hits(eg[s], hit[s], gt_rels[s, :ev], **kw)
            both = PR.scene_recall_topk(logits[s], rel_probs[s], gt_rels[s], gt_class[s],
                                        edge_index[s], topk_each=te, evaluate=mode,
                                        valid_edges=ev, return_both=True, **kw)
            for g, w, x in zip(got, want, both):
                np.testing.assert_allclose(g, x, err_msg=f"{mode}/{te} scene {s}")
                np.testing.assert_array_equal(g, w, err_msg=f"{mode}/{te} scene {s}")


@pytest.mark.parametrize("evaluate", ["triplet", "rels"])
def test_tally_ranked_candidates_equals_jax(evaluate):
    """Random ranked candidate lists (repeated edges, hits and misses)."""
    rng = np.random.RandomState(13)
    c, nrel, ev, kmax = 6, 5, 12, 40
    gt_rels = (rng.rand(ev, nrel) < 0.3).astype(np.float32)
    sub_cls, obj_cls = rng.randint(0, c, ev), rng.randint(0, c, ev)
    sel_edges = rng.randint(0, ev, kmax)
    hi = c * c * nrel if evaluate == "triplet" else nrel
    sel_idx = rng.randint(0, hi, kmax)
    if evaluate == "triplet":  # plant some exact GT triplets
        for r in range(0, kmax, 3):
            e = sel_edges[r]
            p = int(np.argmax(gt_rels[e]))
            sel_idx[r] = (sub_cls[e] * c + obj_cls[e]) * nrel + p
    kw = dict(topk=(5, 10, 40), num_rel_classes=nrel, evaluate=evaluate, c=c)
    got = PR.tally_ranked_candidates(sel_edges, sel_idx, gt_rels, sub_cls, obj_cls, **kw)
    want = JR.tally_ranked_candidates(sel_edges, sel_idx, gt_rels, sub_cls, obj_cls, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].max() > 0


def test_evaluate_topk_equals_jax():
    """tests/test_surface_tails.py:136-200's inputs: multi-label at topk
    101 and 8 (saturation), and the single-label path."""
    rng = np.random.RandomState(3)
    n, c, r, e = 7, 12, 5, 10
    objs_logp = np.log(rng.dirichlet(np.ones(c), size=n)).astype(np.float32)
    rels_sig = rng.rand(e, r).astype(np.float32)
    edges = np.stack([rng.randint(0, n, e), rng.randint(0, n, e)], axis=1)
    gt_rel = []
    for _ in range(e):
        k = int(rng.randint(0, 4))
        preds = list(rng.choice(r, size=k, replace=False))
        gt_rel.append((int(rng.randint(0, c)), int(rng.randint(0, c)), [int(p) for p in preds]))
    rels_logp = np.log(rng.dirichlet(np.ones(r), size=e)).astype(np.float32)
    for rels, multi, topk in ((rels_sig, True, 101), (rels_sig, True, 8),
                              (rels_logp, False, 101)):
        got = PM.evaluate_topk(objs_logp, rels, gt_rel, edges, multi_rel_outputs=multi,
                               topk=topk)
        want = JM.evaluate_topk(objs_logp, rels, gt_rel, edges, multi_rel_outputs=multi,
                                topk=topk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[0]) > 0


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_wire_nbytes_equals_jax(dtype):
    """tests/test_wire.py:55-66's batch, with text targets: the same count
    as JAX's, and the f16 count equal to the encoded batch's bytes."""
    jb = jax.tree_util.tree_map(np.asarray, make_batch(
        seed=3, node_counts=(13, 14, 15, 16) * 2, num_points=32, bucket=16, with_text=True))
    pb = SceneBatch(**{k: None if v is None else torch.from_numpy(np.array(v))
                       for k, v in vars(jb).items()})
    got = wire_nbytes(pb, dtype=dtype)
    assert got == jax_wire_nbytes(jb, dtype=dtype)
    enc = encode_wire(pb, dtype=dtype)
    assert got == sum(v.numel() * v.element_size() for v in vars(enc).values()
                      if v is not None)
    if dtype != "float32":
        assert wire_nbytes(pb, dtype="float32") / got >= 2.0
