"""The port's packed splits, card-resident splits, grouped evaluation and
resident multi-step trainer against the JAX package's, on the CPU.

* Packs: a JAX-written pack read by the port gives every ``batch()``
  bit-equal to JAX's; the port's ``pack_scenes`` (serial, per-scene seeds,
  two spawn workers, the NumPy path) writes the JAX pack of the same split
  and seed (manifest equal, arrays bit-equal, the NumPy-path descriptor at
  rtol 1e-3 / atol 1e-4), and the JAX package reads it.
* Loaders: ``PackedLoader`` epochs, variant cycling and per-bucket batch
  maps, ``resolve_batch`` and ``epoch_permutations`` equal JAX's.
* Training: the resident multi-step equals the streaming multi-step on the
  same rows bit for bit (dropout on); against JAX's
  ``make_resident_multi_train_step`` with dropout off on both sides, the
  trajectory gate of tests/test_torch_port_train.py (losses rtol 1e-4,
  parameters atol 3 x lr, BatchNorm statistics rtol 1e-4 / atol 1e-3).
* Evaluation: ``evaluate()`` over ``PackedLoader``, ``ResidentEvalLoader``,
  ``ResidentGroupedEval`` (one bucket and several, full and partial groups)
  and a per-bucket batch map gives equal metrics, on the bit-exact f32 wire;
  the metrics equal JAX ``evaluate()`` over the same pack on bridged weights.

Mirrors tests/test_resident.py (its sharded case excepted),
test_packed_pipeline.py and test_bucket_batch.py.
"""

from __future__ import annotations

import functools
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.mini_data import make_mini_dataset
from tests.test_torch_port_model import NARROW, flax_variables, port_config
from tests.torch_threads import single_thread  # noqa: F401
from vlsat_tpu.data import packed as JPK
from vlsat_tpu.data import resident as JR
from vlsat_tpu.data.bucket_batch import resolve_batch as jax_resolve_batch
from vlsat_tpu.data.dataset import SSGScenes as JaxScenes
from vlsat_tpu.eval.engine import evaluate as jax_evaluate
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu.train import optim as JO
from vlsat_tpu.train.state import TrainState as JaxState
from vlsat_tpu.train.step import make_eval_step as flax_eval_step
from vlsat_tpu.train.step import make_resident_multi_train_step as jax_resident_multi
from vlsat_tpu_torch.data.bucket_batch import DEFAULT_EVAL_BATCH, resolve_batch
from vlsat_tpu_torch.data.dataset import SSGScenes
from vlsat_tpu_torch.data.packed import PackedLoader, PackedScenes, build_scenes, pack_scenes
from vlsat_tpu_torch.data.resident import (ResidentEvalLoader, ResidentGroupedEval,
                                           ResidentScenes, epoch_permutations, gather_rows,
                                           split_nbytes)
from vlsat_tpu_torch.data.synthetic import make_synthetic_split
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from vlsat_tpu_torch.models.layers import Dropout
from vlsat_tpu_torch.models.mmgnet import MMGNet
from vlsat_tpu_torch.train.optim import make_optimizer
from vlsat_tpu_torch.train.state import create_train_state
from vlsat_tpu_torch.train.step import (make_eval_step, make_multi_train_step,
                                        make_resident_multi_train_step, stack_batches)

# NARROW widths with the split's own label space (160 objects, 26 predicates)
WIDTHS = dict(NARROW, num_obj_classes=160, num_rel_classes=26)
JCFG = FlaxConfig(**WIDTHS)
CFG = port_config(JCFG)
FEAT = JCFG.clip_feat_dim
TEXT = np.random.RandomState(0).randn(40, 512).astype(np.float32)
FIELDS = ("obj_points", "obj_mask", "descriptor", "obj_2d_feats", "gt_class", "edge_index",
          "edge_mask", "gt_rels", "rel_text_idx", "rel_points", "rel_text_feat")


def text_lookup(gt_class, gt_rels, edge_index):
    """Per-edge 512-d text targets that depend on the labels only (so the
    pack deduplicates them into a table)."""
    if len(edge_index) == 0:
        return np.zeros((0, 512), np.float32)
    key = gt_class[edge_index[:, 0]] * 3 + gt_rels.argmax(-1)
    return np.ascontiguousarray(TEXT[key % len(TEXT)])


def scenes_kwargs(root, scans, **kw):
    return dict(root=root, scans_root=scans, split="train_scans", num_points=16,
                feat_dim=FEAT, triplet_text_lookup=text_lookup, **kw)


def assert_batches_equal(got, want, what=""):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), (what, f)
        if w is not None:
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape, (what, f)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {f}")


def assert_same_metrics(got: dict, want: dict, what=""):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = float(got[k])
        assert (np.isnan(g) and np.isnan(w)) or g == w, (what, k, g, w)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """tests/test_resident.py's split: 4 scans of 5 instances (one bucket),
    packed by the JAX package with two variants and a text table."""
    tmp = tmp_path_factory.mktemp("mini")
    root, scans = make_mini_dataset(tmp, num_scans=4, insts_per_scan=5)
    out = str(tmp / "jax_pack")
    JPK.pack_scenes(JaxScenes(**scenes_kwargs(root, scans)), out, seed=7, variants=2)
    return root, scans, out


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """tests/test_bucket_batch.py's split: 10 scans of 4-14 instances
    (buckets 8 and 12), from PLY files, packed by the port."""
    tmp = tmp_path_factory.mktemp("multi")
    root, scans, _ = make_synthetic_split(str(tmp / "split"), num_scans=10,
                                          insts_per_scan=(4, 14), vertices_per_inst=60,
                                          rels_per_scan=4, seed=0, write_ply=True)
    out = str(tmp / "pack")
    pack_scenes(SSGScenes(**scenes_kwargs(root, scans)), out, seed=0)
    packed = PackedScenes(out)
    assert len(packed.buckets) >= 2, packed.buckets
    return packed


# ------------------------------------------------------------------ packs

def test_jax_pack_reads_bit_equal(mini):
    _, _, out = mini
    got, want = PackedScenes(out), JPK.PackedScenes(out)
    assert got.buckets == want.buckets and len(got) == len(want) == 4
    assert got.variants == want.variants == 2 and got.max_gt == want.max_gt
    np.testing.assert_array_equal(got.w_cls_obj, want.w_cls_obj)
    np.testing.assert_array_equal(got.text_table, want.text_table)
    for v in range(2):
        for b in got.buckets:
            c = got.count(b)
            for idx in (slice(None), slice(1, 3), np.array([3, 0, 2])):
                g = got.batch(b, idx, v)
                assert_batches_equal(g, want.batch(b, idx, v), f"v{v} b{b} {idx}")
                assert g.obj_points.numpy().flags.writeable  # a private copy
            assert c == 4
    assert split_nbytes(got) == JR.split_nbytes(want) > 0


PACK_MODES = {
    "serial": dict(),
    "per_scene_seed": dict(per_scene_seed=True),
    "two_workers": dict(workers=2),
    "numpy_path_union_points": dict(use_native=False, with_union_points=True, variants=2),
    "drop_relation_free": dict(drop_relation_free=True),
}


def _pack_files(root):
    return sorted(f for f in os.listdir(root))


@pytest.mark.parametrize("mode", sorted(PACK_MODES))
def test_port_pack_equals_jax_pack(mini, tmp_path, mode):
    root, scans, _ = mini
    kw = dict(PACK_MODES[mode])
    scene_kw = {k: kw.pop(k) for k in ("use_native", "with_union_points") if k in kw}
    args = scenes_kwargs(root, scans, **scene_kw)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    extra = {}
    if kw.get("workers"):
        extra = dict(scenes_factory=functools.partial(build_scenes, args))
        jax_extra = dict(scenes_factory=functools.partial(JPK.build_scenes, args))
    else:
        jax_extra = {}
    manifest = pack_scenes(SSGScenes(**args), port_out, seed=11, **kw, **extra)
    JPK.pack_scenes(JaxScenes(**args), jax_out, seed=11, **kw, **jax_extra)
    assert _pack_files(port_out) == _pack_files(jax_out)
    with open(os.path.join(port_out, "manifest.json"), "rb") as a, \
            open(os.path.join(jax_out, "manifest.json"), "rb") as b:
        assert a.read() == b.read()
    assert manifest == json.load(open(os.path.join(jax_out, "manifest.json")))
    worst = 0.0
    for name in _pack_files(port_out):
        if not name.endswith(".npy"):
            continue
        g, w = np.load(os.path.join(port_out, name)), np.load(os.path.join(jax_out, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith("_descriptor.npy") and scene_kw.get("use_native") is False:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4, err_msg=name)
            worst = max(worst, float(np.abs(g - w).max()))
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    print(f"{mode}: largest descriptor difference {worst:.3g}")
    # the JAX package reads the port's pack
    got, want = PackedScenes(port_out), JPK.PackedScenes(port_out)
    for b in got.buckets:
        assert_batches_equal(got.batch(b, slice(None)), want.batch(b, slice(None)), f"b{b}")
    if mode == "drop_relation_free":
        assert len(got) == 3  # the relation-free mini scan is left out


def test_pack_refuses_workers_without_a_factory_and_old_formats(mini, tmp_path):
    root, scans, out = mini
    with pytest.raises(ValueError, match="scenes_factory"):
        pack_scenes(SSGScenes(**scenes_kwargs(root, scans)), str(tmp_path / "x"), workers=2)
    old = tmp_path / "old"
    old.mkdir()
    (old / "manifest.json").write_text(json.dumps({"format": 1, "buckets": {}}))
    with pytest.raises(ValueError, match="format 1"):
        PackedScenes(str(old))


# ---------------------------------------------------------------- loaders

@pytest.mark.parametrize("kw", [dict(batch_size=3), dict(batch_size=3, shuffle=True, seed=1),
                                dict(batch_size=2, shuffle=True, drop_last=True, seed=4),
                                dict(batch_size={4: 2, 8: 3, 16: 1}, shuffle=True, seed=2)])
def test_packed_loader_equals_jax(multi, kw):
    jpacked = JPK.PackedScenes(multi.root)
    loader, jloader = PackedLoader(multi, **kw), JPK.PackedLoader(jpacked, **kw)
    assert len(loader) == len(jloader) and loader.max_gt == jloader.max_gt
    for epoch in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == (len(loader) if epoch == 0 else len(want))
        for g, w in zip(got, want):
            assert_batches_equal(g, w, f"epoch {epoch}")
        assert loader.epoch == epoch + 1
    seen = sum(int(b.obj_mask.any(1).sum()) for b in PackedLoader(multi, **kw))
    if not kw.get("drop_last"):
        assert seen == len(multi)


def test_variants_cycle_per_epoch(mini):
    _, _, out = mini
    packed = PackedScenes(out)
    loader = PackedLoader(packed, batch_size=4)
    first, second, third = ([*loader][0] for _ in range(3))  # one batch per epoch
    assert torch.equal(first.gt_class, second.gt_class)
    assert torch.equal(first.edge_index, second.edge_index)
    assert (first.obj_points - second.obj_points).abs().max() > 0  # another draw
    assert torch.equal(first.obj_points, third.obj_points)
    b = packed.buckets[0]
    assert torch.equal(second.obj_points, packed.batch(b, slice(0, 4), variant=1).obj_points)


def test_resolve_batch_equals_jax():
    table = {8: 64, 16: 32, 64: 8}
    for bucket in (4, 8, 12, 16, 24, 48, 64, 128):
        assert resolve_batch(table, bucket) == jax_resolve_batch(table, bucket)
        assert resolve_batch(32, bucket) == 32
    assert resolve_batch(table, 12) == 32 and resolve_batch(table, 128) == 8
    assert sorted(DEFAULT_EVAL_BATCH) == [4, 8, 12, 16, 24, 32, 48, 64]
    assert all(isinstance(v, int) and v > 0 for v in DEFAULT_EVAL_BATCH.values())


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_permutations_equal_jax(shuffle):
    counts = {8: 7, 16: 5, 12: 9}
    for epoch in range(3):
        got = list(epoch_permutations(counts, group=2, epoch=epoch, seed=1, shuffle=shuffle))
        want = list(JR.epoch_permutations(counts, group=2, epoch=epoch, seed=1,
                                          shuffle=shuffle))
        assert len(got) == len(want) == 3 + 2 + 4
        for (gb, gp), (wb, wp) in zip(got, want):
            assert gb == wb and gp.dtype == wp.dtype == np.int32
            np.testing.assert_array_equal(gp, wp)


def test_resident_split_and_gather_equal_host_rows(multi):
    resident = ResidentScenes(multi, device="cpu")
    for b in multi.buckets:
        full = resident.full_batch(b)
        assert_batches_equal(full, JPK.PackedScenes(multi.root).batch(b, slice(None)))
        rows = np.random.RandomState(b).permutation(multi.count(b)).astype(np.int32)
        got = gather_rows(full, torch.from_numpy(rows))
        assert_batches_equal(got, multi.batch(b, rows), f"b{b}")
    assert split_nbytes(multi) == sum(
        getattr(resident.full_batch(b), f).numel() * getattr(resident.full_batch(b), f)
        .element_size() for b in multi.buckets for f in multi.fields(b))


# --------------------------------------------------------------- training

def _port_model(dropout: bool = True) -> MMGNet:
    params, stats = flax_variables(tuple(WIDTHS.items()), seed=5)
    model = MMGNet(CFG)
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


@pytest.mark.usefixtures("single_thread")
def test_resident_multi_step_equals_streaming_multi_step(mini):
    """Bit-equal losses and weights on the same rows, dropout on (step i
    seeds its masks with fold_in(rng, i) on both paths)."""
    _, _, out = mini
    packed = PackedScenes(out)
    b = packed.buckets[0]
    perm = np.asarray([2, 0, 3, 1], np.int32)
    spec = make_optimizer(lr=1e-3, max_iteration=100)
    runs = []
    for resident in (False, True):
        model = _port_model()
        state = create_train_state(model, spec)
        kw = dict(text_table=packed.text_table, device="cpu")
        if resident:
            split = ResidentScenes(packed, device="cpu").full_batch(b)
            step = make_resident_multi_train_step(model, spec, split, batch_size=2, **kw)
            state, aux = step(state, perm, 3)
            unbound = make_resident_multi_train_step(model, spec, batch_size=2, **kw)
            with pytest.raises(ValueError, match="batches of 2"):
                unbound(state, split, perm[:3], 3)
        else:
            group = stack_batches([packed.batch(b, perm[:2]), packed.batch(b, perm[2:])])
            state, aux = make_multi_train_step(model, spec, **kw)(state, group, 3)
        assert state.step == 2
        runs.append((aux, model.state_dict()))
    (a1, s1), (a2, s2) = runs
    assert torch.equal(a1["losses"], a2["losses"]) and torch.equal(a1["loss"], a2["loss"])
    for k, v in s1.items():
        assert torch.equal(v, s2[k]), k


def test_resident_multi_step_equals_jax(mini, monkeypatch):
    """Dropout off on both sides (flax's Dropout patched to identity)."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    _, _, out = mini
    packed = PackedScenes(out)
    jpacked = JPK.PackedScenes(out)
    b = packed.buckets[0]
    perm = np.asarray([3, 1, 0, 2], np.int32)
    params, stats = flax_variables(tuple(WIDTHS.items()), seed=5)
    jopt = JO.make_optimizer(lr=1e-3, max_iteration=50)
    jstate = JaxState(params=params, batch_stats=stats, opt_state=jopt.init(params),
                      step=jnp.zeros((), jnp.int32))
    jstep = jax_resident_multi(FlaxMMGNet(cfg=JCFG), jopt,
                               JR.ResidentScenes(jpacked).full_batch(b), batch_size=2,
                               donate=False, text_table=jpacked.text_table)
    jstate, jaux = jstep(jstate, jnp.asarray(perm), jax.random.PRNGKey(0))

    model = _port_model(dropout=False)
    spec = make_optimizer(lr=1e-3, max_iteration=50)
    state = create_train_state(model, spec)
    step = make_resident_multi_train_step(
        model, spec, ResidentScenes(packed, device="cpu").full_batch(b), batch_size=2,
        text_table=packed.text_table, device="cpu")
    state, aux = step(state, perm, 0)
    np.testing.assert_allclose(aux["losses"].numpy(), np.asarray(jaux["losses"]), rtol=1e-4)
    got_p, got_s = state_dict_to_flax(model.state_dict())
    for tree, want, (rtol, atol) in ((got_p, jstate.params, (0, 3e-3)),
                                     (got_s, jstate.batch_stats, (1e-4, 1e-3))):
        flat = dict(_leaves(tree))
        for k, w in _leaves(want):
            np.testing.assert_allclose(flat[k], np.asarray(w), rtol=rtol, atol=atol, err_msg=k)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, np.asarray(v)


# ------------------------------------------------------------- evaluation

@functools.lru_cache(maxsize=None)
def _eval_state():
    params, stats = flax_variables(tuple(WIDTHS.items()), seed=5)
    return params, stats, flax_to_state_dict(params, stats, MMGNet(CFG))


def _port_metrics(loader, **kw):
    _, _, state = _eval_state()
    return evaluate(make_eval_step(MMGNet(CFG), device="cpu"), state, loader,
                    **{"verbose": False, **kw})


@pytest.mark.usefixtures("single_thread")
@pytest.mark.parametrize("which", ["mini", "multi"])
def test_evaluate_over_every_loader_is_equal(mini, multi, monkeypatch, which):
    """tests/test_resident.py:64-175 and test_bucket_batch.py:62-75: the
    streaming, resident and grouped loaders (a partial tail batch, full and
    partial groups, a per-bucket batch map) give the same metrics."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    packed = PackedScenes(mini[2]) if which == "mini" else multi
    resident = ResidentScenes(packed, device="cpu")
    base = _port_metrics(PackedLoader(packed, batch_size=3))
    table = {b: (4 if b <= 8 else 2) for b in packed.buckets}
    loaders = {"resident": ResidentEvalLoader(resident, 3),
               "grouped_1": ResidentGroupedEval(resident, 3, group=1),
               "grouped_2": ResidentGroupedEval(resident, 3, group=2),
               "grouped_3": ResidentGroupedEval(resident, 3, group=3),
               "grouped_map": ResidentGroupedEval(resident, table, group=2),
               "streaming_map": PackedLoader(packed, batch_size=table)}
    for name, loader in loaders.items():
        assert len(loader) == len(PackedLoader(packed, batch_size=loader.batch_size))
        assert_same_metrics(_port_metrics(loader), base, name)
    with pytest.raises(ValueError, match="group"):
        ResidentGroupedEval(resident, 3, group=0)
    # scene recall rides the grouped path too
    assert_same_metrics(_port_metrics(ResidentGroupedEval(resident, 3, group=2),
                                      scene_recall=True),
                        _port_metrics(ResidentEvalLoader(resident, 3), scene_recall=True),
                        "scene_recall")


def test_grouped_items_pad_the_tail(multi):
    resident = ResidentScenes(multi, device="cpu")
    items = list(ResidentGroupedEval(resident, 3, group=2))
    b = multi.buckets[-1]
    c = multi.count(b)
    hosts, full, idx = items[-1]
    assert idx.shape == (2, 3) and idx.dtype == np.int32 and idx.max() == c - 1
    assert all(h.num_scenes == 3 for h in hosts)
    tail = hosts[-1]
    live = c - 3 * ((c - 1) // 3)
    assert not tail.obj_mask[live:].any() and tail.obj_mask[:live].any(1).all()
    assert full is resident.full_batch(b)


@pytest.mark.parametrize("which", ["mini", "multi"])
def test_evaluate_equals_jax_over_the_same_pack(mini, multi, monkeypatch, which):
    """The port's grouped resident evaluation against JAX evaluate() over
    JAX's streaming loader of the same pack, bridged weights, f32 wire."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    root = mini[2] if which == "mini" else multi.root
    params, stats, _ = _eval_state()
    jpacked = JPK.PackedScenes(root)
    kw = dict(verbose=False, scene_recall=which == "mini")
    want = jax_evaluate(flax_eval_step(FlaxMMGNet(cfg=JCFG)), params, stats,
                        JPK.PackedLoader(jpacked, batch_size=3), **kw)
    resident = ResidentScenes(PackedScenes(root), device="cpu")
    got = _port_metrics(ResidentGroupedEval(resident, 3, group=2), **kw)
    assert_same_metrics(got, want, which)
