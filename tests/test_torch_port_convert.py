"""A JAX run's checkpoints carried into the port by
``tools/flax_ckpt_to_torch.py``, the port's CLI on a variant, and SGPN's
union point clouds through the port's runner, on the CPU.

The split is ``tests/mini_data.make_mini_dataset`` (6 scans of 4
instances); MODEL widths are narrow (N_LAYERS 1, DIM_ATTEN 64, NUM_HEADS
2; 16 points an instance).  Dropout is off on both sides (flax's
``Dropout`` patched to identity, the port's ``Dropout.forward`` too).
Gates: weights bit for bit after the conversion; forwards at the gate of
tests/test_parity_torch.py (fp32, rtol 1e-3, atol 1e-4); logged losses at
rtol 1e-4 and validation metrics equal, on the bit-exact f32 wire, as in
tests/test_torch_port_runner.py.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import flax.linen
import jax
import numpy as np
import pytest

from tests.mini_data import make_mini_dataset
from tests.test_torch_port_model import to_torch
from tests.test_torch_port_packed import assert_same_metrics
from tests.test_torch_port_train import _assert_states_close, leaves
from tools.flax_ckpt_to_torch import convert
from vlsat_tpu import main as jax_main
from vlsat_tpu.config import load_config as jax_load_config
from vlsat_tpu.data.dataset import SceneLoader as JaxSceneLoader
from vlsat_tpu.train.runner import Runner as JaxRunner
from vlsat_tpu.train.step import make_train_step as jax_train_step
from vlsat_tpu_torch import clipsem as PC
from vlsat_tpu_torch.config import load_config
from vlsat_tpu_torch.data.packed import PackedLoader, PackedScenes
from vlsat_tpu_torch.data.resident import ResidentEvalLoader, ResidentScenes
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.interop.from_flax import state_dict_to_flax, train_state_from_flax
from vlsat_tpu_torch.main import main
from vlsat_tpu_torch.models.layers import Dropout
from vlsat_tpu_torch.train.checkpoint import CheckpointManager
from vlsat_tpu_torch.train.runner import Runner
from vlsat_tpu_torch.train.step import make_eval_step, make_train_step

RTOL, ATOL = 1e-3, 1e-4
# the trajectory gate of tests/test_torch_port_train.py after one AdamW step
STATE_TOL = ((0, 3e-3), (1e-4, 1e-3))


def tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The split, a triplet text cache and the base experiment JSON."""
    tmp = tmp_path_factory.mktemp("convert")
    root, scans = make_mini_dataset(tmp, num_scans=6)
    from vlsat_tpu.data.dataset import SSGScenes as JaxScenes

    index = JaxScenes(root=root, scans_root=scans, split="train_scans").index
    cache = PC.TripletTextCache(index.class_names, index.relation_names)
    cache.build(cache.sentences_for_index(index.scenes), PC.HashTextEncoder())
    cache.save(str(tmp / "triplets.npz"))
    return {
        "MAX_EPOCHES": 1, "Batch_Size": 2, "VALID_INTERVAL": 1, "LOG_INTERVAL": 1,
        # JAX's CLI applies these process-wide: keep them as they are
        "COMPILE_CACHE_DIR": "", "PRNG_IMPL": str(jax.config.jax_default_prng_impl),
        "MODEL": {"N_LAYERS": 1, "DIM_ATTEN": 64, "NUM_HEADS": 2,
                  "triplet_text_cache": str(tmp / "triplets.npz")},
        "dataset": {"root": root, "scans_root": scans, "cache_root": str(tmp / "cache"),
                    "num_points": 16},
    }


def write(path: Path, base: dict, **top) -> str:
    cfg = json.loads(json.dumps(base))
    for k, v in top.items():
        if isinstance(v, dict):
            cfg.setdefault(k, {}).update(v)
        else:
            cfg[k] = v
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture
def no_dropout_either(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x, rng=None: x)
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")


def events(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _split_events(recs):
    losses = [(r["step"], r["train/loss"]) for r in recs if "train/loss" in r]
    (metrics,) = [dict(r) for r in recs if "mean_recall_50" in r]
    metrics.pop("time")
    return losses, metrics


def test_cli_one_epoch_from_converted_state_matches_jax(mini, tmp_path, no_dropout_either):
    """The JAX run's initial state, saved by its ``CheckpointManager`` and
    converted by the tool; then one epoch of ``vlsat_tpu.main --mode train``
    and of ``vlsat_tpu_torch.main --mode train --device cpu`` for
    ``MmgnetSingle``, each resuming from its own copy."""
    jpath = write(tmp_path / "jax.json", mini, NAME="MmgnetSingle", PATH=str(tmp_path / "jax"))
    ppath = write(tmp_path / "port.json", mini, NAME="MmgnetSingle",
                  PATH=str(tmp_path / "port"))
    jr = JaxRunner(jax_load_config(jpath, overrides={"MODE": "train"}))
    assert not jr.load(allow_fallback=True)
    jr.ckpt.save(jr.state)
    jr.close()
    assert convert(jpath, str(tmp_path / "port")) == [(0, None)]

    jax_main.main(["--config", jpath, "--mode", "train"])
    got_final = main(["--config", ppath, "--mode", "train", "--device", "cpu"])
    rel = os.path.join("logs", "MmgnetSingle", "default", "events.jsonl")
    got_losses, got_metrics = _split_events(events(os.path.join(tmp_path, "port", rel)))
    want_losses, want_metrics = _split_events(events(os.path.join(tmp_path, "jax", rel)))
    assert [s for s, _ in got_losses] == [s for s, _ in want_losses] and len(got_losses) >= 2
    np.testing.assert_allclose([v for _, v in got_losses], [v for _, v in want_losses],
                               rtol=1e-4)
    assert got_metrics.pop("step") == want_metrics.pop("step")
    assert_same_metrics(got_metrics, want_metrics, "epoch validation")
    assert_same_metrics({k: v for k, v in got_final.items() if k in want_metrics},
                        want_metrics, "closing validation")


def test_converted_checkpoints_keep_steps_metrics_and_next_step(mini, tmp_path,
                                                                no_dropout_either):
    """Two JAX checkpoints (the initial state scored 0.25, and the state
    after one epoch unscored): the port's manager holds both with their
    scores, restores each bit for bit, runs the same forward as JAX on it,
    and takes the next train step to the same place."""
    path = write(tmp_path / "cfg.json", mini, NAME="MmgnetSingle", PATH=str(tmp_path / "jax"),
                 VALID_INTERVAL=0)
    jcfg = jax_load_config(path, overrides={"MODE": "train"})
    jr = JaxRunner(jcfg)
    jr.load(allow_fallback=True)
    jr.ckpt.save(jr.state, 0.25)
    first = tree(jr.state.params)
    jr.train()  # saves the epoch's last step, unscored
    step = int(jr.state.step)
    assert step >= 2
    out = str(tmp_path / "port")
    assert convert(path, out) == [(0, 0.25), (step, None)]

    pr = Runner(load_config(path, overrides={"MODE": "train", "PATH": out}), device="cpu")
    mgr = CheckpointManager(os.path.join(pr.exp_dir, "checkpoints"))
    assert (mgr.best_step, mgr.latest_step) == (0, step)
    assert pr.load(best=True) and pr.state.step == 0
    for k, w in leaves(first):
        np.testing.assert_array_equal(dict(leaves(state_dict_to_flax(
            pr.model.state_dict())[0]))[k], w, err_msg=k)
    assert pr.load() and pr.state.step == step
    params, stats = state_dict_to_flax(pr.model.state_dict())
    for k, w in leaves(tree(jr.state.params)):
        np.testing.assert_array_equal(dict(leaves(params))[k], w, err_msg=k)

    batch = next(iter(JaxSceneLoader(jr.valid_scenes, batch_size=2, shuffle=False)))
    want = jr.model.apply({"params": jr.state.params, "batch_stats": jr.state.batch_stats},
                          batch)
    got = make_eval_step(pr.model, device="cpu")(pr.model.state_dict(), to_torch(batch))
    mask = {"obj": np.asarray(batch.obj_mask), "rel": np.asarray(batch.edge_mask)}
    for key, w in want.items():
        m = mask[key.split("_")[0]]
        np.testing.assert_allclose(got[key].numpy()[m], np.asarray(w)[m], rtol=RTOL,
                                   atol=ATOL, err_msg=key)

    train_batch = next(iter(JaxSceneLoader(jr.train_scenes, batch_size=2, shuffle=False,
                                           drop_last=True)))
    jstate, jaux = jax_train_step(jr.model, jr.optimizer, donate=False,
                                  objective=jr.loss_fn)(jr.state, train_batch,
                                                         jax.random.PRNGKey(0))
    state, aux = make_train_step(pr.model, pr.optimizer, objective=pr.loss_fn,
                                 device="cpu")(pr.state, to_torch(train_batch), 0)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    assert state.step == int(jstate.step) == step + 1
    _assert_states_close(state, tree(jstate), STATE_TOL)
    jr.close()
    pr.close()


def test_sgpn_runner_reads_union_points(mini, tmp_path, no_dropout_either):
    """``NAME`` SGPN turns on the union point clouds (the dataset's
    ``with_union_points`` stays false): one epoch of both runners from one
    bridged state gives equal losses and metrics; the port's pack tool packs
    the clouds, and evaluating them resident equals evaluating them
    streamed."""
    path = write(tmp_path / "cfg.json", mini, NAME="SGPN", PATH=str(tmp_path / "run"),
                 dataset={"packed_root": None, "num_points_union": 32})
    jcfg = jax_load_config(path, overrides={"MODE": "train", "PATH": str(tmp_path / "jax")})
    pcfg = load_config(path, overrides={"MODE": "train"})
    assert not pcfg.dataset.with_union_points
    jr = JaxRunner(jcfg)
    jr.load(allow_fallback=True)
    pr = Runner(pcfg, device="cpu")
    pr.state = train_state_from_flax(tree(jr.state.params), tree(jr.state.batch_stats),
                                     tree(jr.state.opt_state), 0, model=pr.model,
                                     optimizer=pr.optimizer)
    jr.train()
    pr.train()
    jr.close()
    pr.close()
    rel = os.path.join("logs", "SGPN", "default", "events.jsonl")
    got_losses, got_metrics = _split_events(events(os.path.join(tmp_path, "run", rel)))
    want_losses, want_metrics = _split_events(events(os.path.join(tmp_path, "jax", rel)))
    np.testing.assert_allclose([v for _, v in got_losses], [v for _, v in want_losses],
                               rtol=1e-4)
    assert_same_metrics(got_metrics, want_metrics, "SGPN validation")

    from vlsat_tpu_torch.tools.pack_dataset import main as pack_main

    packed_root = str(tmp_path / "pack")
    pack_main(["--config", path, "--out", packed_root, "--splits", "validation"])
    packed = PackedScenes(os.path.join(packed_root, "validation"))
    bucket = packed.buckets[0]
    assert "rel_points" in packed.fields(bucket)
    rp = packed.batch(bucket, slice(None)).rel_points
    assert rp.shape[-2:] == (32, 4) and rp.abs().sum() > 0
    step = make_eval_step(pr.model, device="cpu")
    state = pr.model.state_dict()
    streamed = evaluate(step, state, PackedLoader(packed, batch_size=2),
                        num_rel_classes=pr.num_rel)
    resident = evaluate(step, state, ResidentEvalLoader(ResidentScenes(packed, device="cpu"),
                                                        2), num_rel_classes=pr.num_rel)
    assert_same_metrics(resident, streamed, "resident vs streamed")
