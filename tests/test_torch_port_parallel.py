"""The port's data parallelism against the JAX package's 8-device CPU mesh
and its one-device runs, on the CPU.

The port runs as 2 gloo ranks, spawned once for the module
(``parallel.spawn_ranks`` with a FileStore under ``tmp_path``); every case
runs in that one spawn (``tests/torch_parallel_ranks.py``) while this
process computes the references.  Inputs come from numpy seeds at NARROW
widths, with scenes of unequal node and edge counts on the two ranks (the
per-rank-mean bug shows there).

* Train steps, the flagship (with its ``mlp_3d`` ``MaskedBatchNorm``), the
  single-label mode and ``SGGpoint``, dropout off on both sides: the port's
  dp=2 against JAX's dp=8 (and, for the flagship, dp=1; JAX's own tests
  hold its dp=8 equal to its dp=1) -- losses rtol 1e-5; after one SGD step
  every leaf within max(5e-5, 1e-2 x its update)
  (tests/test_production_shape_sharding.py:76-77), after three
  (tests/test_train_step.py:90) the same gate and losses rtol 1e-5; both
  ranks hold the same numbers.
* Dropout on: the port's dp=2 against its dp=1 (one process), SGD at the
  gates above and three AdamW steps' losses rtol 1e-5.
* Evaluation: ``evaluate()`` over ragged 7- and 5-scene batches sharded
  (``shard_eval_batches``), fed JAX's forward outputs, against JAX's
  ``evaluate()`` at dp=1 and dp=8; the port's own forward sharded against
  unsharded; ``ResidentShardedEval`` (group 1 and 2) and the streamed pack
  against the unsharded port over the same pack (which
  tests/test_torch_port_packed.py holds equal to JAX's): metrics rtol 1e-6,
  atol 1e-9.  Rank 0 alone writes the artifacts.
* The refusals of uneven batches, and ``main --data-parallel --device cpu``
  for one epoch with 2 ranks against one rank's run.
"""

from __future__ import annotations

import functools
import json
import os
import threading
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.mini_data import make_mini_dataset
from tests.test_torch_port_model import NARROW, flax_variables, port_config, to_torch
from tests.test_torch_port_packed import assert_same_metrics, scenes_kwargs
from tests.test_torch_port_train import leaves
from tests.torch_threads import one_thread  # noqa: F401
from vlsat_tpu import scene as JSC
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.eval import engine as jengine
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu.models import sggpoint as JS
from vlsat_tpu.parallel import make_mesh, replicate
from vlsat_tpu.parallel import shard_batch as jax_shard
from vlsat_tpu.parallel import shard_eval_batches as jax_shard_eval
from vlsat_tpu.train import losses as JL
from vlsat_tpu.train.state import TrainState as JaxState
from vlsat_tpu.train.step import make_eval_step as flax_eval_step
from vlsat_tpu.train.step import make_train_step as jax_train_step
from vlsat_tpu_torch import parallel
from vlsat_tpu_torch.data.dataset import SSGScenes
from vlsat_tpu_torch.data.packed import PackedLoader, PackedScenes, pack_scenes
from vlsat_tpu_torch.data.resident import ResidentShardedEval
from vlsat_tpu_torch.data.synthetic import make_synthetic_split
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from vlsat_tpu_torch.models import sggpoint as PS
from vlsat_tpu_torch.models.mmgnet import MMGNet
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.train import losses as TL
from vlsat_tpu_torch.train.step import make_eval_step

LOSS_RTOL = 1e-5
METRIC_TOL = dict(rtol=1e-6, atol=1e-9)
NODES = (5, 8, 3, 6, 4, 7, 2, 8)        # rank 0: 22 nodes, rank 1: 21
TEXT_DIM = 512
EVAL_WIDTHS = dict(NARROW, num_obj_classes=160, num_rel_classes=26)
SGG = dict(num_obj_classes=20, num_rel_classes=7, dim=512, num_heads=4, knn_k=8)


def text_batch(seed: int, nodes=NODES, bucket: int = 8, points: int = 8, obj=20, rel=7,
               feat=64, single_label: bool = False):
    """A JAX batch with unit-norm 512-d text targets (the rel-mimic
    loss's); ``single_label`` makes ``gt_rels`` one-hot over the R slots."""
    b = make_batch(seed=seed, node_counts=nodes, num_points=points, bucket=bucket,
                   feat_dim=feat, num_obj_classes=obj, num_rel_classes=rel)
    rng = np.random.RandomState(seed + 100)
    t = rng.randn(b.num_scenes, b.num_edges, TEXT_DIM).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    t *= np.asarray(b.edge_mask)[..., None]
    b = b.replace(rel_text_feat=jnp.asarray(t))
    if single_label:
        labels = rng.randint(0, rel, (b.num_scenes, b.num_edges))
        b = b.replace(gt_rels=jnp.asarray(np.eye(rel, dtype=np.float32)[labels]))
    return b


# ------------------------------------------------------------ the cases

def _flagship(multi_rel: bool = True):
    widths = tuple(dict(NARROW, multi_rel_outputs=multi_rel).items())
    jcfg = FlaxConfig(**dict(widths))
    params, stats = flax_variables(widths, seed=5)
    model = MMGNet(port_config(jcfg))
    return (FlaxMMGNet(cfg=jcfg), params, stats, MMGNet, port_config(jcfg),
            flax_to_state_dict(params, stats, model),
            functools.partial(JL.vlsat_total_loss, multi_rel=multi_rel),
            functools.partial(TL.vlsat_total_loss, multi_rel=multi_rel))


def _sggpoint():
    jcfg = JS.SGGpointConfig(**SGG)
    jmodel = JS.SGGpoint(cfg=jcfg)
    b = text_batch(0, nodes=(4, 6), points=32, feat=SGG["dim"])
    v = jmodel.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}, b,
                    istrain=True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    cfg = PS.SGGpointConfig(**SGG)
    model = PS.SGGpoint(cfg)
    return (jmodel, params, stats, PS.SGGpoint, cfg, flax_to_state_dict(params, stats, model),
            JS.sggpoint_loss, PS.sggpoint_loss)


TRAIN_CASES = {
    # name -> (model factory, batch seeds, batch kwargs, JAX device counts)
    "flagship": (_flagship, (30, 31, 32), {}, (1, 8)),
    "single_label": (functools.partial(_flagship, False), (40, 41, 42),
                     {"single_label": True}, (8,)),
    "sggpoint": (_sggpoint, (50, 51, 52), {"points": 32, "feat": SGG["dim"]}, (8,)),
}


@functools.lru_cache(maxsize=None)
def train_case(name: str):
    factory, seeds, kw, _ = TRAIN_CASES[name]
    jmodel, params, stats, cls, cfg, sd, jloss, ploss = factory()
    batches = [text_batch(s, **kw) for s in seeds]
    return jmodel, params, stats, cls, cfg, sd, jloss, ploss, batches


def port_spec(name: str, opt: str = "sgd", dropout: bool = False) -> dict:
    _, _, _, cls, cfg, sd, _, ploss, batches = train_case(name)
    return dict(model_cls=cls, cfg=cfg, state=sd, dropout=dropout, opt=opt,
                lr=1e-2 if opt == "sgd" else 1e-3, loss=ploss,
                batches=[to_torch(b) for b in batches])


@functools.lru_cache(maxsize=None)
def port_dp1(name: str, opt: str = "sgd", dropout: bool = False) -> dict:
    """The case's steps in this process, without a group."""
    return ranks.train(port_spec(name, opt, dropout))


@functools.lru_cache(maxsize=None)
def jax_train(name: str, devices: int):
    """JAX SGD steps over the case's batches on 1 or 8 devices, dropout
    off: (losses, params after step 1, params after step 3, initial params)."""
    jmodel, params, stats, _, _, _, jloss, _, batches = train_case(name)
    opt = optax.sgd(1e-2)
    state = JaxState(params=params, batch_stats=stats, opt_state=opt.init(params),
                     step=jnp.zeros((), jnp.int32))
    step = jax_train_step(jmodel, opt, objective=lambda o, b: jloss(o, b), donate=False)
    mesh = make_mesh(jax.devices()[:8]) if devices == 8 else None
    if mesh is not None:
        state = replicate(state, mesh)
    old = flax.linen.Dropout.__call__
    flax.linen.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
    try:
        losses, after = [], []
        for i, b in enumerate(batches):
            state, aux = step(state, b if mesh is None else jax_shard(b, mesh),
                              jax.random.PRNGKey(i))
            losses.append(float(aux["loss"]))
            after.append(dict(leaves(jax.tree_util.tree_map(np.asarray, state.params))))
    finally:
        flax.linen.Dropout.__call__ = old
    return losses, after[0], after[-1], dict(leaves(params))


def assert_sgd_gate(port_state: dict, want: dict, before: dict, what: str):
    """Every leaf within max(5e-5, 1e-2 x the leaf's update)."""
    got = dict(leaves(state_dict_to_flax({k: torch.from_numpy(v)
                                          for k, v in port_state.items()})[0]))
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k].T if got[k].shape != w.shape else got[k]
        diff = float(np.abs(g - w).max()) if w.size else 0.0
        upd = float(np.abs(w - before[k]).max()) if w.size else 0.0
        assert diff <= max(5e-5, 1e-2 * upd), (what, k, diff, upd)


# --------------------------------------------------------- evaluation

@functools.lru_cache(maxsize=None)
def eval_case():
    jcfg = FlaxConfig(**EVAL_WIDTHS)
    params, stats = flax_variables(tuple(EVAL_WIDTHS.items()), seed=5)
    sd = flax_to_state_dict(params, stats, MMGNet(port_config(jcfg)))
    batches = [make_batch(seed=s, node_counts=n, num_points=8, bucket=8, feat_dim=64,
                          num_obj_classes=160, num_rel_classes=26)
               for s, n in ((60, (5, 8, 3, 6, 4, 7, 2)), (61, (6, 2, 8, 5, 3)))]
    return jcfg, params, stats, sd, batches


def eval_kw():
    vocab = {f"{s} {o} {p}" for s in range(0, 160, 7) for o in range(160) for p in range(1, 26)}
    return dict(num_rel_classes=26, train_triplet_vocab=vocab, scene_recall=True)


@pytest.fixture(scope="module")
def eval_pack(tmp_path_factory):
    """10 scans of 4-14 instances (buckets 8 and 12) packed by the port."""
    tmp = tmp_path_factory.mktemp("pack")
    root, scans, _ = make_synthetic_split(str(tmp / "split"), num_scans=10,
                                          insts_per_scan=(4, 14), vertices_per_inst=60,
                                          rels_per_scan=4, seed=0, write_ply=True)
    out = str(tmp / "pack")
    pack_scenes(SSGScenes(**scenes_kwargs(root, scans)), out, seed=0)
    return out


# --------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def cli_configs(tmp_path_factory):
    """A mini split packed by the port and three JSONs over it: the
    data-parallel run (resident eval at B=2, ``ResidentShardedEval``), its
    eval mode at B=1 (streamed, padded and sharded), and one process."""
    from vlsat_tpu_torch.tools.pack_dataset import main as pack_main

    tmp = tmp_path_factory.mktemp("cli")
    root, scans = make_mini_dataset(tmp, num_scans=6)
    base = {"NAME": "Mmgnet", "SEED": 3, "MAX_EPOCHES": 1, "Batch_Size": 2,
            "VALID_INTERVAL": 1, "LOG_INTERVAL": 1, "EVAL_BATCH_SIZE": 2,
            "EVAL_RESIDENT": True, "EVAL_GROUP": 2, "TRAIN_RESIDENT": False,
            "MODEL": {"N_LAYERS": 1, "DIM_ATTEN": 64, "NUM_HEADS": 2},
            "dataset": {"root": root, "scans_root": scans, "cache_root": str(tmp / "cache"),
                        "num_points": 16, "packed_root": str(tmp / "pack")}}
    paths = {}
    for name, top in (("dp", {"PATH": str(tmp / "dp")}),
                      ("dp_eval", {"PATH": str(tmp / "dp"), "EVAL_BATCH_SIZE": 1}),
                      ("one", {"PATH": str(tmp / "one")})):
        paths[name] = tmp / f"{name}.json"
        paths[name].write_text(json.dumps({**base, **top}))
    pack_main(["--config", str(paths["dp"])])
    return paths


# ------------------------------------------------------------ the spawn

@pytest.fixture(scope="module")
def dp2(tmp_path_factory, eval_pack, cli_configs):
    """Every rank-side result of one 2-rank spawn, and the work directory."""
    tmp = tmp_path_factory.mktemp("dp2")
    mp = pytest.MonkeyPatch()
    mp.setenv("VLSAT_WIRE_DTYPE", "float32")  # streamed and resident batches bit-equal
    try:
        jcfg, params, stats, sd, batches = eval_case()
        outs = jax_replay_outputs()
        inputs = {
            "train": {**{name: port_spec(name) for name in TRAIN_CASES},
                      "dropout_sgd": port_spec("flagship", "sgd", dropout=True),
                      "dropout_adamw": port_spec("flagship", "adamw", dropout=True)},
            "eval": {"kw": eval_kw(), "batches": [to_torch(b) for b in batches], "outs": outs,
                     "model": dict(model_cls=MMGNet, cfg=port_config(jcfg), state=sd),
                     "pack": eval_pack, "bs": 4, "work": str(tmp)},
            "cli": (str(cli_configs["dp"]), str(cli_configs["dp_eval"])),
        }
        path = str(tmp / "inputs.pt")
        torch.save(inputs, path)
        box = {}

        def background(key, fn, *args, **kw):
            def run():
                try:
                    box[key] = fn(*args, **kw)
                except BaseException as e:  # re-raised below, in the test's thread
                    box["error"] = e
            th = threading.Thread(target=run)
            th.start()
            return th

        # the ranks and the one-process CLI run while this process computes
        # the JAX references
        threads = [background("out", parallel.spawn_ranks, ranks.run, 2, path, device="cpu",
                              store_dir=str(tmp), timeout_s=300),
                   background("cli", cli_one_process, cli_configs["one"])]
        for name, (*_, devices) in TRAIN_CASES.items():
            for d in devices:
                jax_train(name, d)
        jax_eval_refs()
        for th in threads:
            th.join(timeout=900)
            assert not th.is_alive(), "the ranks or the one-process CLI run did not finish"
        if "error" in box:
            raise box["error"]
        yield box["out"], tmp
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def jax_replay_outputs():
    """JAX's forward outputs on each ragged batch padded to 8 scenes."""
    jcfg, params, stats, _, batches = eval_case()
    step = flax_eval_step(FlaxMMGNet(cfg=jcfg))
    return [{k: np.asarray(v) for k, v in step(params, stats,
                                               JSC.pad_batch_scenes(b, 8)).items()}
            for b in batches]


@functools.lru_cache(maxsize=None)
def jax_eval_refs():
    """JAX evaluate() over the ragged batches on 1 device and on the 8-device
    mesh."""
    jcfg, params, stats, _, batches = eval_case()
    step = flax_eval_step(FlaxMMGNet(cfg=jcfg))
    kw = dict(eval_kw(), verbose=False)
    one = jengine.evaluate(step, params, stats, list(batches), **kw)
    mesh = make_mesh(jax.devices()[:8])
    eight = jengine.evaluate(step, params, stats, jax_shard_eval(list(batches), mesh), **kw)
    return one, eight


def assert_metrics_close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or np.isclose(g, w, **METRIC_TOL), (what, k, g, w)


# ------------------------------------------------------------------ tests

def test_spawned_group_is_two_gloo_ranks_on_the_cpu(dp2):
    out, _ = dp2
    assert out["world"] == (2, "gloo", "cpu")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_sharded_step_loss_matches_jax_dp8_and_dp1(dp2, name):
    out, _ = dp2
    got = out[f"train/{name}"]
    assert got["agree"], "the two ranks hold different losses or weights"
    for devices in TRAIN_CASES[name][-1]:
        losses = jax_train(name, devices)[0]
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=LOSS_RTOL,
                                   err_msg=f"dp={devices}")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_sharded_sgd_step_matches_jax(dp2, name):
    """One step's weights at the update-scaled gate."""
    out, _ = dp2
    for devices in TRAIN_CASES[name][-1]:
        _, after1, _, before = jax_train(name, devices)
        assert_sgd_gate(out[f"train/{name}"]["state_first"], after1, before,
                        f"{name} against dp={devices}")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_three_sharded_sgd_steps_match_jax(dp2, name):
    out, _ = dp2
    got = out[f"train/{name}"]
    for devices in TRAIN_CASES[name][-1]:
        losses, _, after3, before = jax_train(name, devices)
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=f"dp={devices}")
        assert_sgd_gate(got["state"], after3, before, f"{name} against dp={devices}")


def test_sharded_batchnorm_statistics_match_unsharded(dp2):
    """The flagship's mlp_3d MaskedBatchNorm: after 3 steps the running
    statistics of dp=2 (equal on both ranks) equal the one-process run's."""
    out, _ = dp2
    got = out["train/flagship"]["state"]
    want = port_dp1("flagship")["state"]
    keys = [k for k in want if "running_" in k]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_dropout_on_sharded_step_equals_one_process(dp2):
    """Each rank draws the global batch's mask and keeps its block."""
    out, _ = dp2
    spec = port_spec("flagship", "sgd", dropout=True)
    want = port_dp1("flagship", "sgd", True)
    got = out["train/dropout_sgd"]
    assert got["agree"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    no_drop = out["train/flagship"]["losses"]
    assert not np.allclose(got["losses"], no_drop, rtol=1e-3)  # the masks are on
    before = dict(leaves(state_dict_to_flax(spec["state"])[0]))
    want_p = dict(leaves(state_dict_to_flax({k: torch.from_numpy(v)
                                             for k, v in want["state"].items()})[0]))
    assert_sgd_gate(got["state"], want_p, before, "dropout on, dp=2 against dp=1")


def test_three_adamw_steps_with_dropout_equal_one_process(dp2):
    out, _ = dp2
    want = port_dp1("flagship", "adamw", True)
    got = out["train/dropout_adamw"]
    assert got["agree"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for g, w in zip(got["aux"], want["aux"]):  # every logged term is global
        assert sorted(g) == sorted(w)
        np.testing.assert_allclose([g[k] for k in w], list(w.values()), rtol=LOSS_RTOL,
                                   atol=1e-7)


def test_sharded_evaluate_on_jax_outputs_equals_jax(dp2):
    """Ragged 7- and 5-scene batches padded to 8 and 6, each rank fed its
    block of JAX's outputs: the metrics of JAX at dp=1 and dp=8."""
    out, _ = dp2
    assert out["eval/agree"], "the ranks returned different metric dicts"
    one, eight = jax_eval_refs()
    assert_metrics_close(out["eval/replay"], one, "against JAX dp=1")
    assert_metrics_close(out["eval/replay"], eight, "against JAX dp=8")


def test_sharded_evaluate_artifacts_come_from_rank_0(dp2):
    out, tmp = dp2
    assert "result.txt" in out["eval/replay_files"]
    assert "sub_scores_list.npy" in out["eval/replay_files"]
    assert not (tmp / "replay_rank1").exists()


def test_sharded_evaluate_of_the_model_equals_unsharded(dp2):
    out, _ = dp2
    jcfg, _, _, sd, batches = eval_case()
    model = MMGNet(port_config(jcfg))
    want = evaluate(make_eval_step(model, device="cpu"), sd, [to_torch(b) for b in batches],
                    verbose=False, **eval_kw())
    assert_metrics_close(out["eval/model"], want, "the port's forward")


@pytest.mark.parametrize("which", ["streamed_pack", "resident_group1", "resident_group2"])
def test_sharded_pack_evaluation_equals_unsharded(dp2, eval_pack, monkeypatch, which):
    """Buckets 8 and 12 at B=4, partial tail batches and groups."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    out, _ = dp2
    jcfg, _, _, sd, _ = eval_case()
    want = evaluate(make_eval_step(MMGNet(port_config(jcfg)), device="cpu"), sd,
                    PackedLoader(PackedScenes(eval_pack), 4), verbose=False, **eval_kw())
    assert_metrics_close(out[f"eval/{which}"], want, f"{which} against the port's dp=1")


# ------------------------------------------------------------- refusals

def _fake_world(rank: int = 0, size: int = 2) -> parallel.World:
    """A World for the checks that raise before any collective."""
    return parallel.World(rank, size, torch.device("cpu"), "gloo", None, None)


def _port_batch(nodes):
    return to_torch(make_batch(seed=1, node_counts=nodes, num_points=8, bucket=8, feat_dim=64,
                               num_obj_classes=20, num_rel_classes=7))


def test_uneven_batches_are_refused():
    w = _fake_world()
    with pytest.raises(ValueError, match="7 scenes does not divide over 2 devices"):
        parallel.shard_batch(_port_batch((3,) * 7), w)
    stacked = SceneBatch(**{k: None if v is None else v[None].expand(2, *v.shape)
                            for k, v in vars(_port_batch((3,) * 5)).items()})
    with pytest.raises(ValueError, match="stacked batch of 5 scenes"):
        parallel.shard_stacked_batch(stacked, w)
    blocks = [parallel.shard_batch(_port_batch(NODES), _fake_world(r)) for r in (0, 1)]
    assert [b.num_scenes for b in blocks] == [4, 4]
    assert [int(b.obj_mask.sum()) for b in blocks] == [22, 21]


def test_sharded_train_step_refuses_an_uneven_batch():
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_train_step

    jcfg = FlaxConfig(**NARROW)
    model = MMGNet(port_config(jcfg))
    spec = make_optimizer(lr=1e-3, max_iteration=10)
    step = make_train_step(model, spec, device="cpu", world=_fake_world())
    with pytest.raises(ValueError, match="does not divide over 2 devices"):
        step(create_train_state(model, spec), _port_batch((3,) * 3), 0)


def test_resident_sharded_eval_refuses_an_uneven_batch_size(eval_pack):
    packed = PackedScenes(eval_pack)
    with pytest.raises(ValueError, match="does not divide over 2 devices"):
        ResidentShardedEval(packed, _fake_world(), 3)
    with pytest.raises(ValueError, match="does not divide over 2 devices"):
        ResidentShardedEval(packed, _fake_world(), {8: 4, 12: 5})
    with pytest.raises(ValueError, match="group must be >= 1"):
        ResidentShardedEval(packed, _fake_world(), 4, group=0)


def test_shard_eval_batches_pads_to_the_world():
    w = _fake_world()
    wrapped = parallel.shard_eval_batches([_port_batch((3,) * 7), _port_batch((3,) * 4)], w)
    assert wrapped.mesh_sharded and len(wrapped) == 2
    got = list(wrapped)
    assert [b.num_scenes for b in got] == [8, 4]
    assert not bool(got[0].obj_mask[7].any())


# ------------------------------------------------------------------- CLI

@functools.lru_cache(maxsize=None)
def cli_one_process(config: Path) -> dict:
    """``main --mode train --data-parallel --device cpu`` in this process:
    with no launcher on the CPU it runs as one process."""
    from vlsat_tpu_torch.main import main

    return main(["--config", str(config), "--mode", "train", "--data-parallel",
                 "--device", "cpu"])


def _losses(path: Path) -> list:
    with open(path / "logs" / "Mmgnet" / "default" / "events.jsonl") as f:
        return [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]


def _count(root: Path, name: str) -> int:
    return sum(name in dirs or name in files for _, dirs, files in os.walk(root))


def test_cli_data_parallel_equals_one_process(dp2, cli_configs, monkeypatch):
    """``main --data-parallel --device cpu`` with 2 ranks: its logged losses
    equal a one-process run's (rtol 1e-5), its closing validation equals its
    own ``--mode eval`` (streamed at B=1, padded and sharded) and the same
    checkpoint evaluated in one process; rank 0 alone wrote one checkpoint
    directory, one ``result.txt`` and one epoch row."""
    from vlsat_tpu_torch.main import main

    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    out, _ = dp2
    assert out["cli/agree"]
    dp = Path(json.loads(cli_configs["dp"].read_text())["PATH"])
    one = Path(json.loads(cli_configs["one"].read_text())["PATH"])
    assert _count(dp, "checkpoints") == 1 and _count(dp, "result.txt") == 1
    with open(dp / "Mmgnet" / "default" / "epoch_stats.jsonl") as f:
        assert len(f.readlines()) == 1
    cli_one_process(cli_configs["one"])
    got, want = _losses(dp), _losses(one)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_same_metrics(out["cli/eval"], out["cli/train"], "dp eval against dp train")
    single = main(["--config", str(cli_configs["dp_eval"]), "--mode", "eval", "--device",
                   "cpu"])
    assert_metrics_close(single, out["cli/eval"], "one process on the dp checkpoint")
