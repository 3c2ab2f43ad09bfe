"""The port's runner and CLI against the JAX package's, on the CPU: the
config, the model registry, the CLIP text tables, the metric logger, the
runner's train / validation / resume paths, the CLI's eval artifacts, the
HTTP frontend and the pack tool.

Every runner test loads ONE experiment JSON, unchanged, in both packages
(only ``PATH`` differs, so that the two write their own checkpoints).  The
model is the flagship ``Mmgnet`` at narrow MODEL widths (N_LAYERS 1,
DIM_ATTEN 64, NUM_HEADS 2; 16 points an instance) on
``tests/mini_data.make_mini_dataset``.  The two packages draw their first
weights differently, so the port's runner starts from the JAX runner's
initial state (``interop.from_flax``); dropout is off on both sides (flax's
``Dropout`` patched to identity, the port's ``p`` set to 0), as in
tests/test_torch_port_train.py.

Gates: logged ``train/loss`` rtol 1e-4 at every step (the trajectory gate of
tests/test_torch_port_train.py); validation metrics equal
(``assert_same_metrics``) on the bit-exact f32 wire; forwards and ``/predict``
answers at the parity gate of tests/test_parity_torch.py (fp32, rtol 1e-3,
atol 1e-4); text tables, packs and artifacts bit for bit.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import sys
import urllib.error
import urllib.request
from pathlib import Path

import flax.linen
import jax
import numpy as np
import pytest
import torch

from tests.mini_data import make_mini_dataset
from tests.test_torch_port_model import to_torch
from tests.test_torch_port_packed import assert_same_metrics
from vlsat_tpu import clipsem as JC
from vlsat_tpu.config import load_config as jax_load_config
from vlsat_tpu.data import packed as JPK
from vlsat_tpu.data.dataset import SceneLoader as JaxSceneLoader
from vlsat_tpu.data.dataset import SSGScenes as JaxScenes
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.models.registry import build_model as jax_build_model
from vlsat_tpu.train.runner import Runner as JaxRunner
from vlsat_tpu.utils.logging import MetricLogger as JaxLogger
from vlsat_tpu_torch import clipsem as PC
from vlsat_tpu_torch.config import load_config
from vlsat_tpu_torch.data.assets import read_classes, read_relationships
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, train_state_from_flax
from vlsat_tpu_torch.main import main
from vlsat_tpu_torch.models.layers import Dropout
from vlsat_tpu_torch.models.registry import build_model
from vlsat_tpu_torch.train.checkpoint import CheckpointManager
from vlsat_tpu_torch.train.runner import Runner, model_config_from
from vlsat_tpu_torch.train.step import make_eval_step
from vlsat_tpu_torch.utils.logging import MetricLogger

RTOL, ATOL = 1e-3, 1e-4
NARROW_MODEL = {"N_LAYERS": 1, "DIM_ATTEN": 64, "NUM_HEADS": 2}


def tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """6 scans of 4 instances (scan 2 without relations), a triplet text
    cache the port saves (HashTextEncoder over the train index), and the
    split packed by the port's tool."""
    tmp = tmp_path_factory.mktemp("runner")
    root, scans = make_mini_dataset(tmp, num_scans=6)
    index = JaxScenes(root=root, scans_root=scans, split="train_scans").index
    cache = PC.TripletTextCache(index.class_names, index.relation_names)
    cache.build(cache.sentences_for_index(index.scenes), PC.HashTextEncoder())
    cache.save(str(tmp / "triplets.npz"))
    base = {
        "MAX_EPOCHES": 2, "Batch_Size": 2, "VALID_INTERVAL": 2, "LOG_INTERVAL": 1,
        "MODEL": {**NARROW_MODEL, "triplet_text_cache": str(tmp / "triplets.npz")},
        "dataset": {"root": root, "scans_root": scans, "cache_root": str(tmp / "cache"),
                    "num_points": 16, "packed_root": str(tmp / "pack")},
    }
    unpacked = json.loads(json.dumps(base))
    unpacked["dataset"]["packed_root"] = None
    paths = {"packed": tmp / "packed.json", "unpacked": tmp / "unpacked.json"}
    paths["packed"].write_text(json.dumps(base))
    paths["unpacked"].write_text(json.dumps(unpacked))
    from vlsat_tpu_torch.tools.pack_dataset import main as pack_main

    pack_main(["--config", str(paths["packed"])])
    return tmp, paths


def write_config(path: Path, base: Path, **top) -> str:
    """``base`` with top-level keys replaced, as a new JSON file."""
    cfg = json.loads(base.read_text())
    cfg.update(top)
    path.write_text(json.dumps(cfg))
    return str(path)


def both_configs(path: str, out: Path, mode: str):
    over = lambda pkg: {"PATH": str(out / pkg), "MODE": mode}
    return jax_load_config(path, overrides=over("jax")), load_config(path, overrides=over("port"))


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@pytest.fixture
def flax_no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def bridged_runners(jcfg, pcfg):
    """The JAX runner with its fresh initial state, and the port's runner
    (CPU, dropout off) holding the same state."""
    jr = JaxRunner(jcfg)
    assert not jr.load(best=False, allow_fallback=True)
    pr = Runner(pcfg, device="cpu")
    no_dropout(pr.model)
    pr.state = train_state_from_flax(tree(jr.state.params), tree(jr.state.batch_stats),
                                     tree(jr.state.opt_state), 0, model=pr.model,
                                     optimizer=pr.optimizer)
    return jr, pr


def events(cfg) -> list:
    with open(os.path.join(cfg.PATH, "logs", cfg.NAME, cfg.exp, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def epoch_rows(cfg) -> list:
    with open(os.path.join(cfg.PATH, cfg.NAME, cfg.exp, "epoch_stats.jsonl")) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------------------ config

def test_one_json_loads_equal_in_both_packages(mini):
    _, paths = mini
    for path in paths.values():
        for over in (None, {"MODE": "eval", "exp": "x", "EVAL": True, "LOADBEST": False}):
            assert load_config(str(path), over).to_json() == \
                jax_load_config(str(path), over).to_json()


# ---------------------------------------------------------------- registry

def _mcfg(**model):
    return load_config(overrides={"MODEL": {**NARROW_MODEL, **model}}).MODEL


@pytest.mark.parametrize("rgb,normal,channels", [(False, False, 3), (True, False, 6),
                                                 (True, True, 9)])
def test_registry_config_equals_jax(rgb, normal, channels):
    mcfg = _mcfg(USE_RGB=rgb, USE_NORMAL=normal, GCN_AGGR="mean", nn_edge_mode="onehot")
    model, loss = build_model("Mmgnet", 160, 26, mcfg)
    jmodel, jloss = jax_build_model("Mmgnet", 160, 26, mcfg)
    got, want = model.cfg, jmodel.cfg
    shared = [f.name for f in dataclasses.fields(got) if hasattr(want, f.name)]
    assert len(shared) >= 14
    for name in shared:
        assert getattr(got, name) == getattr(want, name), name
    assert got.point_channels == channels and not got.fused_pointnet
    assert loss.keywords == jloss.keywords == {"multi_rel": True}
    cfg = load_config(overrides={"MODEL": dict(mcfg)})
    assert model_config_from(cfg, 160, 26) == got


def test_registry_refuses_what_is_not_ported():
    """Every name of the JAX registry builds, each as its JAX class's
    counterpart; ``Mmgnet`` and ``SGGpoint`` with ``USE_SPATIAL=false``
    have nodes narrower than their attention width, which the JAX models
    fail on and the port refuses (the variants that run without the
    spatial features build: tests/test_torch_port_variants.py,
    tests/test_torch_port_sggpoint.py)."""
    for name in ("Mmgnet", "MmgnetSingle", "SGFN", "SGPN", "SGGpoint", "SGGpointBaseline",
                 "MMteacher", "MmgnetIn21k"):
        model, _ = build_model(name, 160, 26, _mcfg())
        assert type(model).__name__ == type(jax_build_model(name, 160, 26, _mcfg())[0]).__name__
    with pytest.raises(ValueError, match="unknown model"):
        build_model("Nope", 160, 26, _mcfg())
    with pytest.raises(ValueError, match="dim_node"):
        build_model("Mmgnet", 160, 26, _mcfg(USE_SPATIAL=False))
    with pytest.raises(ValueError, match="not dim 512"):
        build_model("SGGpoint", 160, 26, _mcfg(USE_SPATIAL=False))
    with pytest.raises(ValueError, match="nn_edge_mode"):
        build_model("Mmgnet", 160, 26, _mcfg(nn_edge_mode="dense"))


def _rgb_batch(tmp_path):
    """The case of tests/test_rgb_normal.py:112 with RGB only (C=6)."""
    from tests.test_rgb_normal import _mini_with_channels, _scenes

    _mini_with_channels(tmp_path)
    batch = next(iter(JaxSceneLoader(_scenes(tmp_path, use_rgb=True), batch_size=2,
                                     shuffle=False)))
    assert batch.obj_points.shape[-1] == 6
    return batch


@pytest.mark.parametrize("case", ["rgb6", "onehot", "gather"])
def test_registry_forward_matches_jax(tmp_path, case):
    """Both registries' models from one MODEL section, bridged weights."""
    if case == "rgb6":
        mcfg, batch = _mcfg(USE_RGB=True), _rgb_batch(tmp_path)
    else:
        mcfg = _mcfg(nn_edge_mode=case)
        batch = make_batch(seed=3, node_counts=(5, 8, 3), num_points=16, bucket=8)
    jmodel, _ = jax_build_model("Mmgnet", 160, 26, mcfg)
    variables = jmodel.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                            batch, istrain=True)
    want = jmodel.apply(variables, batch, istrain=False)
    model, _ = build_model("Mmgnet", 160, 26, mcfg)
    state = flax_to_state_dict(tree(variables["params"]), tree(variables["batch_stats"]),
                               model)
    got = make_eval_step(model, device="cpu")(state, to_torch(batch))
    masks = {"obj": np.asarray(batch.obj_mask), "rel": np.asarray(batch.edge_mask)}
    assert sorted(got) == sorted(want)
    for key in got:
        mask = masks[key.split("_")[0]]
        np.testing.assert_allclose(got[key].numpy()[mask], np.asarray(want[key])[mask],
                                   rtol=RTOL, atol=ATOL, err_msg=key)


# ------------------------------------------------------------- text tables

def test_prompts_are_byte_equal():
    names = [("chair", "standing on", "floor"), ("tv stand", "attached to", "wall"),
             ("ß", "close by", "é")]
    for s, r, o in names:
        assert PC.object_prompt(s).encode() == JC.object_prompt(s).encode()
        assert PC.relation_prompt(r).encode() == JC.relation_prompt(r).encode()
        assert PC.triplet_prompt(s, r, o).encode() == JC.triplet_prompt(s, r, o).encode()
        assert PC.no_relation_prompt(s, o).encode() == JC.no_relation_prompt(s, o).encode()
    assert not hasattr(PC, "HFCLIPTextEncoder")


def test_hash_encoder_and_label_tables_are_bit_equal(mini):
    tmp, _ = mini
    root = str(tmp / "3dssg")
    sentences = ["a photo of a chair", "", "the chair and the floor has no relation"]
    for dim in (512, 7):
        np.testing.assert_array_equal(PC.HashTextEncoder(dim)(sentences),
                                      JC.HashTextEncoder(dim)(sentences))
    classes, rels = read_classes(root), read_relationships(root)[1:]
    for got, want in zip(PC.build_label_tables(classes, rels, PC.HashTextEncoder()),
                         JC.build_label_tables(classes, rels, JC.HashTextEncoder())):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_text_caches_are_interchangeable(mini, tmp_path):
    tmp, _ = mini
    ds = JaxScenes(root=str(tmp / "3dssg"), scans_root=str(tmp / "scans"),
                   split="train_scans", num_points=16)
    classes, rels = ds.class_names, ds.relation_names
    jcache = JC.TripletTextCache(classes, rels)
    sentences = jcache.sentences_for_index(ds.index.scenes)
    assert sentences == PC.TripletTextCache(classes, rels).sentences_for_index(ds.index.scenes)
    jcache.build(sentences, JC.HashTextEncoder())
    jcache.save(str(tmp_path / "jax.npz"))
    port_saved = str(tmp / "triplets.npz")  # the fixture's cache, saved by the port
    checked = 0
    for i in range(len(ds)):
        s = ds.prepare(i, np.random.RandomState(i))
        args = (s["gt_class"], s["gt_rels"], s["edge_index"])
        want = jcache(*args)
        for got in (PC.TripletTextCache.load(str(tmp_path / "jax.npz"), classes, rels)(*args),
                    JC.TripletTextCache.load(port_saved, classes, rels)(*args),
                    PC.TripletTextCache.load(port_saved, classes, rels)(*args)):
            np.testing.assert_array_equal(got, want)
        checked += int(s["gt_rels"].any(-1).sum())
    assert checked > 0  # edges with GT predicates were looked up
    empty = PC.TripletTextCache(classes, rels)
    with pytest.raises(KeyError, match="rebuild the cache"):
        empty(np.zeros(2, np.int32), np.zeros((2, len(rels)), np.float32),
              np.array([[0, 1], [1, 0]], np.int32))


# ------------------------------------------------------------ metric logger

def test_metric_logger_records_equal_jax(tmp_path):
    items = [("train/loss", np.float32(0.125)), ("Misc/epo", 3), ("val/acc", 7),
             ("nan", float("nan"))]
    for cls, d in ((MetricLogger, "port"), (JaxLogger, "jax")):
        logger = cls(str(tmp_path / d))
        logger.log(items, 5)
        logger.log(items[:1], np.int64(6))
        logger.close()
    recs = {}
    for d in ("port", "jax"):
        with open(tmp_path / d / "events.jsonl") as f:
            recs[d] = [line for line in f]
    assert len(recs["port"]) == 2
    for got, want in zip(recs["port"], recs["jax"]):
        got, want = json.loads(got), json.loads(want)
        assert isinstance(got.pop("time"), float) and isinstance(want.pop("time"), float)
        assert json.dumps(got) == json.dumps(want)


# ------------------------------------------------------------------ runner

RUNNER_CASES = {
    "unpacked": ("unpacked", {}),
    "packed_microsteps": ("packed", {"TRAIN_RESIDENT": False, "TRAIN_MICROSTEPS": 2,
                                     "EVAL_GROUP": 1}),
    "packed_resident": ("packed", {"TRAIN_RESIDENT": True, "EVAL_GROUP": 4,
                                   "EVAL_BATCH_SIZE": "auto"}),
}


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_two_epochs_match_jax(mini, tmp_path, monkeypatch, flax_no_dropout, case):
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    _, paths = mini
    base, top = RUNNER_CASES[case]
    path = write_config(tmp_path / "cfg.json", paths[base], **top)
    jcfg, pcfg = both_configs(path, tmp_path, "train")
    jr, pr = bridged_runners(jcfg, pcfg)
    try:
        jr.train()
        pr.train()
        assert pr.state.step == int(jr.state.step) > 0
    finally:
        jr.close()
        pr.close()
    got, want = events(pcfg), events(jcfg)
    losses = lambda recs: [(r["step"], r["train/loss"]) for r in recs if "train/loss" in r]
    assert [s for s, _ in losses(got)] == [s for s, _ in losses(want)]
    assert len(losses(got)) >= 2
    np.testing.assert_allclose([v for _, v in losses(got)], [v for _, v in losses(want)],
                               rtol=1e-4)
    assert sorted(got[0]) == sorted(want[0])  # the same logged terms
    metrics = lambda recs: [r for r in recs if "mean_recall_50" in r]
    (gm,), (wm,) = metrics(got), metrics(want)
    assert gm.pop("step") == wm.pop("step")
    gm.pop("time"), wm.pop("time")
    assert_same_metrics(gm, wm, case)
    rows, jrows = epoch_rows(pcfg), epoch_rows(jcfg)
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    for r, w in zip(rows, jrows):
        assert (r["epoch"], r["step"], r["scenes"]) == (w["epoch"], w["step"], w["scenes"])
    assert CheckpointManager(os.path.join(pr.exp_dir, "checkpoints")).latest_step == \
        pr.state.step


def test_resume_restores_step_and_schedule(mini, tmp_path):
    """tests/test_runner.py:48-55 on the port, then a resumed epoch; a
    damaged checkpoint raises unless the caller allows the fallback, which
    archives it."""
    _, paths = mini
    path = write_config(tmp_path / "cfg.json", paths["packed"], MAX_EPOCHES=1)
    _, cfg = both_configs(path, tmp_path, "train")
    r = Runner(cfg, device="cpu")
    r.load(best=False, allow_fallback=True)
    r.train()
    step, n_batches = r.state.step, 2  # 5 train scenes with relations, B=2
    assert step == n_batches
    r.close()
    for best in (False, True):
        r2 = Runner(cfg, device="cpu")
        assert r2.load(best=best)
        assert r2.state.step == step
        r2.close()
    cfg2 = cfg.merged({"MAX_EPOCHES": 2})
    r3 = Runner(cfg2, device="cpu")
    assert r3.load()
    # the schedule at the restored step under this run's max_iteration
    spec_factor = r3.optimizer.factor()
    for group in r3.state.optimizer.param_groups:
        base = next(g["lr"] for g in r3.optimizer.param_groups(r3.model)
                    if g["label"] == group["label"])
        assert group["lr"] == pytest.approx(base * spec_factor(step), rel=1e-12)
    r3.train()  # start_epoch = 1 + step // len(loader) = 2
    assert r3.state.step == 2 * n_batches
    assert [row["epoch"] for row in epoch_rows(cfg2)] == [1, 2]
    r3.close()

    ckpt_dir = Path(r3.exp_dir) / "checkpoints"
    for f in ckpt_dir.glob("ckpt_*.pt"):
        f.write_bytes(b"not a checkpoint")
    r4 = Runner(cfg2, device="cpu")
    with pytest.raises(RuntimeError, match="checkpoint restore failed"):
        r4.load()
    assert not r4.load(allow_fallback=True)
    assert r4.state.step == 0 and not list(ckpt_dir.glob("ckpt_*.pt"))
    assert list(ckpt_dir.parent.glob("checkpoints.stale-*"))
    r4.close()


def test_use_pretrain_trains_the_predictors_only(mini, tmp_path):
    """``MODEL.use_pretrain`` (reference load_pretrain_model): the weights of
    the pretrain run's best checkpoint, then only the modules with
    "predictor" in their name train, as the JAX runner's
    ``freeze_non_predictor`` groups do."""
    _, paths = mini
    path = write_config(tmp_path / "cfg.json", paths["packed"], MAX_EPOCHES=1)
    _, cfg = both_configs(path, tmp_path, "train")
    first = Runner(cfg, device="cpu")
    first.load(allow_fallback=True)
    first.train()
    first.close()
    pre = {k: v.clone() for k, v in first.model.state_dict().items()}
    cfg2 = cfg.merged({"PATH": str(tmp_path / "second"),
                       "MODEL": {"use_pretrain": os.path.join(first.exp_dir, "checkpoints")}})
    second = Runner(cfg2, device="cpu")
    second.load(allow_fallback=True)
    second.train()
    second.close()
    assert second.state.step == first.state.step
    moved = {k for k, v in second.model.named_parameters() if not torch.equal(v, pre[k])}
    assert moved and all("predictor" in k.split(".")[0] for k in moved), sorted(moved)


def test_runner_refuses_cuda_without_a_card(mini, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, paths = mini
    _, cfg = both_configs(str(paths["packed"]), tmp_path, "eval")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runner(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", str(paths["packed"]), "--mode", "eval"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", str(paths["packed"]), "--mode", "trace"])
    path = write_config(tmp_path / "trace.json", paths["packed"], PATH=str(tmp_path / "out"))
    report = main(["--config", path, "--mode", "trace", "--device", "cpu"])
    assert report["checked_small"] and report["checked_large"]


# --------------------------------------------------------------------- CLI

def _jax_eval_config(path: str, out: Path):
    """What JAX's CLI resolves for ``--mode eval`` (vlsat_tpu/main.py:35-38),
    writing under ``out``."""
    over = {"MODE": "eval", "exp": "default", "EVAL": True, "LOADBEST": False}
    return jax_load_config(path, overrides=over), jax_load_config(
        path, overrides={**over, "PATH": str(out)})


def test_cli_eval_writes_the_jax_artifacts(mini, tmp_path, monkeypatch):
    """``main --mode eval --device cpu`` on a checkpoint of bridged weights
    writes the files, metrics and rank lists that the JAX runner's eval mode
    (``validation(save=True, with_scores=True)``) writes on the same
    weights, and archives the config JAX's CLI archives."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    _, paths = mini
    path = write_config(tmp_path / "eval.json", paths["unpacked"], PATH=str(tmp_path / "port"))
    resolved, jcfg = _jax_eval_config(path, tmp_path / "jax")
    pcfg = load_config(path, overrides={"MODE": "eval"})
    jr, pr = bridged_runners(jcfg, pcfg)
    CheckpointManager(os.path.join(pr.exp_dir, "checkpoints")).save(pr.state)
    pr.close()
    try:
        want = jr.validation(save=True, with_scores=True)
    finally:
        jr.close()
    got = main(["--config", path, "--mode", "eval", "--device", "cpu"])
    assert_same_metrics(got, want, "eval")
    res = lambda cfg: Path(cfg.PATH) / "results" / "Mmgnet" / "default"
    names = sorted(os.listdir(res(pcfg)))
    assert names == sorted(os.listdir(res(jcfg)))
    assert {"result.txt", "topk_pred_list.npy", "topk_triplet_list.npy",
            "cls_matrix_list.npy", "sub_scores_list.npy"} <= set(names)
    for name in names:
        g, w = res(pcfg) / name, res(jcfg) / name
        if name == "result.txt":
            assert g.read_text() == w.read_text()
        elif name.endswith("_scores_list.npy"):
            np.testing.assert_allclose(np.load(g), np.load(w), rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(np.load(g), np.load(w), err_msg=name)
    archived = Path(pcfg.PATH) / "Mmgnet" / "default" / "config.json"
    assert archived.read_text() == resolved.to_json()


# ----------------------------------------------------------------- serving

def _post(port: int, path: str, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("eval_3d_only", [True, False])
def test_serve_answers_equal_jax(mini, tmp_path, monkeypatch, eval_3d_only):
    """``Runner.serve(port=0)`` of both packages on bridged weights, f32 wire:
    equal answers at the gate, /healthz counts (the port's also its failed
    batches), 400 on a bad payload, 404 elsewhere."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    _, paths = mini
    path = write_config(tmp_path / "serve.json", paths["unpacked"], EVAL_3D_ONLY=eval_3d_only)
    jcfg, pcfg = both_configs(path, tmp_path, "serve")
    jr, pr = bridged_runners(jcfg, pcfg)
    scenes = [pr.valid_scenes.prepare(i, np.random.RandomState(i)) for i in (0, 1, 3)]
    try:
        with jr.serve(port=0, max_batch=2) as jfe, pr.serve(port=0, max_batch=2) as pfe:
            for s in scenes:
                body = _npz(obj_points=s["obj_points"], descriptor=s["descriptor"],
                            obj_2d_feats=s["obj_2d_feats"])
                (gc, g), (wc, w) = _post(pfe.port, "/predict", body), \
                    _post(jfe.port, "/predict", body)
                assert gc == wc == 200
                g, w = np.load(io.BytesIO(g)), np.load(io.BytesIO(w))
                assert sorted(g.files) == sorted(w.files) == ["edge_index", "obj_logits",
                                                               "rel_cls"]
                np.testing.assert_array_equal(g["edge_index"], w["edge_index"])
                for key in ("obj_logits", "rel_cls"):
                    assert g[key].shape == w[key].shape
                    np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL, err_msg=key)
            code, health = _get(pfe.port, "/healthz")
            health = json.loads(health)
            assert code == 200 and health["ok"] and health["scenes"] == len(scenes)
            # the JAX server's keys, and the port's count of failed batches
            assert set(health) == set(json.loads(_get(jfe.port, "/healthz")[1])) | {"failed"}
            assert health["failed"] == 0
            code, err = _post(pfe.port, "/predict", _npz(obj_points=scenes[0]["obj_points"]))
            assert code == 400
            assert json.loads(err)["error"].startswith("ValueError: payload needs")
            assert _post(pfe.port, "/predict", b"not an npz")[0] == 400
            assert _get(pfe.port, "/nope")[0] == _post(pfe.port, "/nope", b"")[0] == 404
    finally:
        jr.close()
        pr.close()


@pytest.mark.parametrize("name", ["MmgnetSingle", "SGFN", "MMteacher"])
def test_eval_3d_only_runs_a_variants_full_forward(mini, tmp_path, monkeypatch, name):
    """``EVAL_3D_ONLY`` is the serving mode of ``MMGNet``: both runners run
    any other model's full forward under it (vlsat_tpu/train/runner.py:530,
    553), with equal validation metrics and equal served answers."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    _, paths = mini
    path = write_config(tmp_path / "variant.json", paths["unpacked"], NAME=name,
                        EVAL_3D_ONLY=True)
    jcfg, pcfg = both_configs(path, tmp_path, "eval")
    jr, pr = bridged_runners(jcfg, pcfg)
    s = pr.valid_scenes.prepare(0, np.random.RandomState(0))
    body = _npz(obj_points=s["obj_points"], descriptor=s["descriptor"],
                obj_2d_feats=s["obj_2d_feats"])
    try:
        assert_same_metrics(pr.validation(), jr.validation(), name)
        with jr.serve(port=0, max_batch=2) as jfe, pr.serve(port=0, max_batch=2) as pfe:
            (gc, g), (wc, w) = _post(pfe.port, "/predict", body), _post(jfe.port, "/predict", body)
        assert gc == wc == 200
        g, w = np.load(io.BytesIO(g)), np.load(io.BytesIO(w))
        np.testing.assert_array_equal(g["edge_index"], w["edge_index"])
        for key in ("obj_logits", "rel_cls"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL, err_msg=key)
    finally:
        jr.close()
        pr.close()


# --------------------------------------------------------------- pack tool

def test_pack_tool_equals_jax_tool(mini, tmp_path, monkeypatch):
    """The fixture's pack (``python -m vlsat_tpu_torch.tools.pack_dataset``)
    against tools/pack_dataset.py on the same JSON, byte for byte, the train
    split's text table included."""
    import importlib.util

    tmp, paths = mini
    spec = importlib.util.spec_from_file_location(
        "jax_pack_tool", Path(__file__).resolve().parents[1] / "tools" / "pack_dataset.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "jax_pack"
    monkeypatch.setattr(sys, "argv", ["pack_dataset.py", "--config", str(paths["packed"]),
                                      "--out", str(out)])
    tool.main()
    for split in ("train", "validation"):
        got, want = tmp / "pack" / split, out / split
        names = sorted(os.listdir(got))
        assert names == sorted(os.listdir(want))
        for name in names:
            assert (got / name).read_bytes() == (want / name).read_bytes(), (split, name)
    assert "text_table.npy" in os.listdir(tmp / "pack" / "train")
    assert JPK.PackedScenes(str(tmp / "pack" / "train")).text_table.shape[1] == 512
