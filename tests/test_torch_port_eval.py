"""The port's evaluation path against the JAX package's (CPU).

* Rank functions: object and predicate ranks, the multi-GT discounting and
  the sorted GT preds are bit-equal to JAX on the same inputs; triplet ranks
  are bit-equal when both packages get the same object probabilities (the
  port's core takes probabilities; XLA's and torch's softmax differ in the
  last ulp of some entries), with both methods, at the shapes of
  tests/test_metrics.py and on inputs full of exact ties.
* Scene recall: ranked candidate edges and hit flags equal JAX's on the
  cases of tests/test_recall.py, and the host tally is the same.
* ``evaluate()`` by injection: a step returning the JAX forward's outputs
  gives the metrics dict of JAX ``evaluate()``, key for key and value for
  value; the integer artifacts of ``save_dir`` and the raw relation scores
  are array-equal, and the scores the engine computes (softmax, exp) agree
  to the last ulp.
* ``evaluate()`` end to end: the port's own forward on the mini dataset of
  tests/test_golden_metrics.py reproduces tests/golden/metrics_mini.json.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import NARROW, flax_variables, port_config, to_torch
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.eval import engine as jengine
from vlsat_tpu.eval import metrics as jm
from vlsat_tpu.eval import recall as jr
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu.scene import full_edge_index
from vlsat_tpu.train.step import make_eval_step as flax_eval_step
from vlsat_tpu_torch.eval import engine as tengine
from vlsat_tpu_torch.eval import metrics as tm
from vlsat_tpu_torch.eval import recall as tr

T = torch.from_numpy


def _eq(got: torch.Tensor, want, msg: str = ""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


# ----------------------------------------------------------------- ranks

def _logits_with_ties(rng, shape, scale=2.0):
    """Logits rounded to a coarse grid: many exact ties in every rank."""
    return (np.round(rng.randn(*shape) * scale * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
def test_object_and_predicate_ranks_are_bit_equal(ties):
    rng = np.random.RandomState(1)
    logits = (_logits_with_ties(rng, (3, 9, 160)) if ties
              else rng.randn(3, 9, 160).astype(np.float32) * 3)
    gt = rng.randint(0, 160, (3, 9)).astype(np.int32)
    _eq(tm.object_ranks(T(logits), T(gt)), jm.object_ranks(logits, gt, topk=11))
    probs = rng.rand(3, 40, 26).astype(np.float32)
    if ties:
        probs = np.round(probs * 4) / 4
    got = tm.predicate_rank_parts(T(probs), topk=6)
    want = jm.predicate_rank_parts(probs, topk=6)
    for g, w in zip(got, want):
        _eq(g, w)


def test_discounting_and_sorted_preds_are_bit_equal():
    rng = np.random.RandomState(2)
    ranks = rng.randint(1, 103, (4, 30, 26)).astype(np.int32)
    no_gt = rng.randint(1, 103, (4, 30)).astype(np.int32)
    gt_rels = (rng.rand(4, 30, 26) < 0.1).astype(np.float32)
    gt_rels[0, :5] = 0.0  # no-GT edges
    gt_rels[1, 0] = 1.0   # every class on one edge
    _eq(tm.discounted_ranks_device(T(ranks), T(no_gt), T(gt_rels)),
        jm.discounted_ranks_device(ranks, no_gt, gt_rels))
    _eq(tm.sorted_gt_preds_device(T(gt_rels)), jm.sorted_gt_preds_device(gt_rels))


def test_host_assembly_equals_jax_and_the_device_discounting():
    """The numpy assemblies equal JAX's, and the engine's path (discounted on
    the device, offset by R-1, each edge's first max(#GT, 1) slots) gives
    the same rank list."""
    rng = np.random.RandomState(6)
    e, r, c = 50, 26, 12
    cr = rng.randint(1, 103, (e, r)).astype(np.int32)
    ng = rng.randint(1, 103, e).astype(np.int32)
    gt = (rng.rand(e, r) < 0.1).astype(np.float32)
    gt[:10] = 0.0
    got = tm.assemble_predicate_topk(cr, ng, gt)
    np.testing.assert_array_equal(got, jm.assemble_predicate_topk(cr, ng, gt))
    vals = tm.discounted_ranks_device(T(cr), T(ng), T(gt)).numpy().astype(np.int64) - (r - 1)
    valid = np.arange(r)[None, :] < np.maximum((gt > 0).sum(1), 1)[:, None]
    np.testing.assert_array_equal(vals[valid], got)
    args = (cr, ng, gt, rng.randint(0, c, e), rng.randint(0, c, e), rng.randint(1, 12, e),
            rng.randint(1, 12, e), rng.rand(e, c).astype(np.float32),
            rng.rand(e, c).astype(np.float32), rng.rand(e, r).astype(np.float32))
    want = jm.assemble_triplet_topk(*args)
    got = tm.assemble_triplet_topk(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_jax_softmax = jax.jit(lambda x: jax.nn.softmax(x.astype(jnp.float32), axis=-1))


@pytest.mark.parametrize("method", ["topk", "sort"])
@pytest.mark.parametrize("n,c,r,e,topk", [
    (9, 23, 7, 30, 11), (9, 23, 7, 30, 101), (6, 7, 5, 20, 11), (12, 160, 26, 64, 101)])
def test_triplet_ranks_are_bit_equal_on_shared_probs(method, n, c, r, e, topk):
    rng = np.random.RandomState(7)
    for ties in (False, True):
        ol = (_logits_with_ties(rng, (n, c)) if ties
              else rng.randn(n, c).astype(np.float32) * 2)
        gc = rng.randint(0, c, n).astype(np.int32)
        probs = rng.rand(e, r).astype(np.float32)
        if ties:
            probs = np.round(probs * 8) / 8
        ei = np.stack([rng.randint(0, n, e), rng.randint(0, n, e)], -1).astype(np.int32)
        want = jm.triplet_rank_parts(ol, gc, probs, ei, topk=topk, chunk=16, method=method)
        shared = T(np.array(_jax_softmax(ol)))
        got = tm.triplet_rank_parts_from_probs(shared, T(gc), T(probs), T(ei), topk=topk,
                                               chunk=16, method=method)
        for g, w in zip(got, want):
            _eq(g, w, f"ties={ties}")


def test_batched_triplet_ranks_equal_per_scene_jax():
    """The engine's batched call (chunks across scenes) equals JAX's vmap of
    the per-scene function, padded edges included."""
    rng = np.random.RandomState(4)
    b, n, c, r = 3, 8, 40, 9
    e = n * (n - 1)
    ol = rng.randn(b, n, c).astype(np.float32) * 2
    gc = rng.randint(0, c, (b, n)).astype(np.int32)
    probs = rng.rand(b, e, r).astype(np.float32)
    ei = np.broadcast_to(full_edge_index(n), (b, e, 2)).copy()
    ei[1, 20:] = 0  # padding rows
    want = jax.vmap(lambda o, g, p, x: jm.triplet_rank_parts(o, g, p, x, topk=101, chunk=16))(
        ol, gc, probs, ei)
    got = tm.triplet_rank_parts_from_probs(T(np.array(_jax_softmax(ol))), T(gc), T(probs),
                                           T(ei), topk=101, chunk=24)
    for g, w in zip(got, want):
        _eq(g, w)


# ----------------------------------------------------------- scene recall

def _recall_case():
    """The ragged batch of tests/test_recall.py::test_batched_scene_hits_matches_host_path."""
    rng = np.random.RandomState(11)
    b, n_max, c, nrel = 3, 6, 10, 5
    e_max = n_max * (n_max - 1)
    logits = rng.randn(b, n_max, c).astype(np.float32) * 2
    gt_class = rng.randint(0, c, (b, n_max)).astype(np.int32)
    rel_probs = rng.rand(b, e_max, nrel).astype(np.float32)
    edge_index = np.zeros((b, e_max, 2), np.int32)
    edge_mask = np.zeros((b, e_max), bool)
    gt_rels = np.zeros((b, e_max, nrel), np.float32)
    for s, nn in enumerate([6, 4, 5]):
        ei = full_edge_index(nn)
        edge_index[s, :len(ei)] = ei
        edge_mask[s, :len(ei)] = True
        gt_rels[s, :len(ei)] = (rng.rand(len(ei), nrel) < 0.3)
        rel_probs[s, len(ei):] = 0.99
    return logits, rel_probs, edge_index, edge_mask, gt_class, gt_rels


@pytest.mark.parametrize("mode,te", [("triplet", 1), ("triplet", 100), ("rels", 1),
                                     ("rels", 100)])
def test_scene_hits_equal_jax(mode, te):
    args = _recall_case()
    want_e, want_h = jr.batched_scene_hits(*args, topk_each=te, kmax=100, mode=mode)
    got_e, got_h = tr.batched_scene_hits(*map(T, args), topk_each=te, kmax=100, mode=mode)
    _eq(got_e, want_e)
    _eq(got_h, want_h)
    gt_rels, edge_mask = args[5], args[3]
    got = tr.tally_hits_batch(got_e.numpy(), got_h.numpy(), gt_rels, edge_mask,
                              topk=(5, 20, 100), num_rel_classes=5)
    want = jr.tally_hits_batch(np.asarray(want_e), np.asarray(want_h), gt_rels, edge_mask,
                               topk=(5, 20, 100), num_rel_classes=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_tally_equals_jax():
    """The case of tests/test_recall.py::test_tally_hits_batch_matches_per_scene:
    scenes without GT and padded edges included."""
    rng = np.random.RandomState(3)
    b, e, nrel, kmax = 5, 30, 7, 40
    sel = rng.randint(0, e, (b, kmax)).astype(np.int32)
    hits = rng.rand(b, kmax) < 0.25
    gt_rels = (rng.rand(b, e, nrel) < 0.2).astype(np.float32)
    edge_mask = np.zeros((b, e), bool)
    for s, ev in enumerate([30, 12, 0, 20, 7]):
        edge_mask[s, :ev] = True
        gt_rels[s, ev:] = 0.0
        hits[s] &= sel[s] < max(ev, 1)
    gt_rels[3] = 0.0
    got = tr.tally_hits_batch(sel, hits, gt_rels, edge_mask, topk=(5, 20, 40), num_rel_classes=nrel)
    want = jr.tally_hits_batch(sel, hits, gt_rels, edge_mask, topk=(5, 20, 40),
                               num_rel_classes=nrel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_staircase_and_pairtable_equal_jax():
    """The case of tests/test_recall.py::test_staircase_matches_pairtable:
    candidate cube indices equal JAX's (confidences to the softmax's ulp),
    and both candidate methods give JAX's hits, including the binding
    per-edge cap (topk_each=7, kmax=50)."""
    rng = np.random.RandomState(5)
    b, n, c, nrel = 4, 8, 40, 9
    e = n * (n - 1)
    logits = rng.randn(b, n, c).astype(np.float32) * 3
    rel = rng.rand(b, e, nrel).astype(np.float32)
    ei = np.broadcast_to(full_edge_index(n), (b, e, 2)).astype(np.int32)
    for te in (1, 7, 100):
        wc, wi = jr.batched_per_edge_topk(logits, rel, ei, topk_each=te)
        gc_, gi = tr.batched_per_edge_topk(T(logits), T(rel), T(ei.copy()), topk_each=te)
        _eq(gi, wi, f"te={te}")
        np.testing.assert_allclose(gc_.numpy(), np.asarray(wc), rtol=1e-6, atol=0)
        pc, pi = tr.per_edge_topk(T(logits[0]), T(rel[0]), T(ei[0].copy()), topk_each=te)
        _eq(pi, jr.per_edge_topk(logits[0], rel[0], ei[0], topk_each=te)[1])
    em = np.ones((b, e), bool)
    gt_class = rng.randint(0, c, (b, n)).astype(np.int32)
    gt_rels = (rng.rand(b, e, nrel) < 0.2).astype(np.float32)
    for te in (1, 7, 100):
        for m in ("staircase", "pairtable"):
            want = jr.batched_scene_hits(logits, rel, ei, em, gt_class, gt_rels,
                                         topk_each=te, kmax=50, mode="triplet", method=m)
            got = tr.batched_scene_hits(T(logits), T(rel), T(ei.copy()), T(em), T(gt_class),
                                        T(gt_rels), topk_each=te, kmax=50, mode="triplet",
                                        method=m)
            for g, w in zip(got, want):
                _eq(g, w, f"te={te} method={m}")


# ------------------------------------------------------ evaluate() by injection

WIDTHS = dict(NARROW)
R = WIDTHS["num_rel_classes"]


class _Loader(list):
    """A list of batches that declares its GT-slot cap, like a packed loader."""

    def __init__(self, batches, max_gt):
        super().__init__(batches)
        self.max_gt = max_gt


@functools.lru_cache(maxsize=None)
def _injection_setup(multi_rel: bool, branch_3d_only: bool = False):
    """JAX step, variables, batches and the step's outputs; one per mode, so
    the JAX engine's compiled programs are shared between tests."""
    jcfg = FlaxConfig(**WIDTHS, multi_rel_outputs=multi_rel)
    params, stats = flax_variables(tuple(WIDTHS.items()), seed=5)
    batches = [make_batch(seed=s, node_counts=nodes, num_points=8, bucket=bucket,
                          feat_dim=jcfg.clip_feat_dim, num_obj_classes=jcfg.num_obj_classes,
                          num_rel_classes=R)
               for s, nodes, bucket in ((0, (5, 8, 3), 8), (1, (9, 4), 12), (2, (2, 7, 6), 8))]
    step = flax_eval_step(FlaxMMGNet(cfg=jcfg), branch_3d_only=branch_3d_only)
    outs = [{k: np.asarray(v) for k, v in step(params, stats, b).items()} for b in batches]
    return step, params, stats, batches, outs


def _replay(outs):
    """A port-side eval step that returns the JAX forward's outputs, batch
    by batch, as torch tensors."""
    it = iter(outs)

    def step(state, batch):
        return {k: T(v.copy()) for k, v in next(it).items()}

    return step


def _assert_same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or g == w, (k, g, w)


_VOCAB = {f"{s} {o} {p}" for s in range(0, 20, 3) for o in range(20) for p in range(1, R)}


@pytest.mark.parametrize("multi_rel,cap,scene_recall,branch_3d_only", [
    (True, False, False, False),
    (False, False, False, False),
    (True, True, True, False),
    (False, True, True, False),
    (True, False, False, True),
])
def test_evaluate_by_injection_equals_jax(multi_rel, cap, scene_recall, branch_3d_only):
    step, params, stats, batches, outs = _injection_setup(multi_rel, branch_3d_only)
    loader_j, loader_t = list(batches), [to_torch(b) for b in batches]
    if cap:
        max_gt = int(max((np.asarray(b.gt_rels) > 0).sum(-1).max() for b in batches))
        loader_j, loader_t = _Loader(loader_j, max_gt), _Loader(loader_t, max_gt)
    kw = dict(num_rel_classes=R, train_triplet_vocab=_VOCAB, verbose=False,
              multi_rel=multi_rel, scene_recall=scene_recall)
    want = jengine.evaluate(step, params, stats, loader_j, **kw)
    got = tengine.evaluate(_replay(outs), {}, loader_t, **kw)
    _assert_same_metrics(got, want)
    assert ("obj_acc_2d_1" in got) == (not branch_3d_only)
    if scene_recall:
        assert "sgcls_ngc_mean_recall_100" in got


@pytest.mark.parametrize("multi_rel", [True, False])
def test_evaluate_artifacts_equal_jax(tmp_path, multi_rel):
    step, params, stats, batches, outs = _injection_setup(multi_rel)
    kw = dict(num_rel_classes=R, verbose=False, with_scores=True, multi_rel=multi_rel)
    want = jengine.evaluate(step, params, stats, batches, save_dir=str(tmp_path / "jax"), **kw)
    got = tengine.evaluate(_replay(outs), {}, [to_torch(b) for b in batches],
                           save_dir=str(tmp_path / "port"), **kw)
    _assert_same_metrics(got, want)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "sub_scores_list.npy" in names
    for name in names:
        if not name.endswith(".npy"):
            continue
        g, w = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        computed = ("sub_scores_list.npy", "obj_scores_list.npy") + (
            () if multi_rel else ("rel_scores_list.npy",))
        if name in computed:
            # softmax (and, single-label, exp) of the same outputs: XLA's and
            # torch's differ in the last ulp
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    with open(tmp_path / "port" / "result.txt") as f:
        assert f.read().count("Eval: ") == len(got)


def test_evaluate_rejects_a_wrong_gt_cap():
    _, _, _, batches, outs = _injection_setup(True)
    with pytest.raises(ValueError, match="max_gt"):
        tengine.evaluate(_replay(outs), {}, _Loader([to_torch(b) for b in batches], 0),
                         num_rel_classes=R, verbose=False)
    with pytest.raises(ValueError, match="num_rel_classes <= 127"):
        tengine.evaluate(_replay(outs), {}, [], num_rel_classes=128, verbose=False)


# ------------------------------------------------------ evaluate() end to end

def test_port_evaluate_reproduces_golden_metrics(tmp_path):
    from tests.mini_data import make_mini_dataset
    from tests.test_golden_metrics import GOLDEN_PATH
    from vlsat_tpu.data.assets import build_triplet_vocab, load_relationship_json
    from vlsat_tpu.data.dataset import SceneLoader, SSGScenes
    from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict
    from vlsat_tpu_torch.models.mmgnet import MMGNet
    from vlsat_tpu_torch.train.step import make_eval_step

    root, scans = make_mini_dataset(tmp_path)
    scenes = SSGScenes(split="validation_scans", root=root, scans_root=scans,
                       num_points=16, cache_root=str(tmp_path / "cache"))
    loader = SceneLoader(scenes, batch_size=1, shuffle=False)
    batches = list(loader)
    jcfg = FlaxConfig()
    variables = FlaxMMGNet(cfg=jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        batches[0], istrain=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables.get("batch_stats", {}))
    cfg = port_config(jcfg)
    model = MMGNet(cfg)
    state = flax_to_state_dict(params, stats, model)
    vocab = build_triplet_vocab(load_relationship_json(root, "train_scans"),
                                scenes.class_names, scenes.relation_names)
    metrics = tengine.evaluate(
        make_eval_step(model, device="cpu"), state, [to_torch(b) for b in batches],
        num_rel_classes=len(scenes.relation_names), train_triplet_vocab=vocab,
        total=len(scenes), verbose=False)
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert len(golden) == 32 and set(metrics) == set(golden)
    for k, v in golden.items():
        if np.isnan(v):
            assert np.isnan(metrics[k]), k
        else:
            np.testing.assert_allclose(metrics[k], v, rtol=0, atol=1e-4, err_msg=k)
