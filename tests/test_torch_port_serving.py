"""The port's BatchedServer against the JAX package's, and the port's
independence from JAX.

Both servers take the same scenes of mixed sizes (two node buckets) on
bridged weights; per-scene outputs must agree at the model gate (fp32,
rtol 1e-3, atol 1e-4, as tests/test_parity_torch.py), on the bit-exact f32
wire and on the default f16 wire (both packages round f32 to f16 the same
way, so both models see the same inputs).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vlsat_tpu.data.synthetic import make_batch, make_scene
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu.serving import BatchedServer as FlaxServer
from vlsat_tpu.train.step import make_eval_step as flax_eval_step
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict
from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig
from vlsat_tpu_torch.scene import pick_bucket
from vlsat_tpu_torch.serving import BatchedServer, bench_server

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-3, 1e-4
WIDTHS = dict(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
              dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64)


def _setup():
    jcfg = FlaxConfig(**WIDTHS, fused_pointnet=True)
    model = FlaxMMGNet(cfg=jcfg)
    tiny = make_batch(seed=1, node_counts=(3,), num_points=8, bucket=4, feat_dim=64,
                      num_obj_classes=20, num_rel_classes=7)
    # an istrain init holds every leaf the port's model has (the triplet projector)
    v = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                   tiny, istrain=True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    cfg = MMGNetConfig(**WIDTHS, fused_pointnet=True)
    return model, params, stats, cfg, flax_to_state_dict(params, stats, MMGNet(cfg))


def _scenes(sizes=(3, 7, 5, 11, 4, 9)):  # buckets 4, 8 and 12
    rng = np.random.RandomState(0)
    out = []
    for n in sizes:
        s = make_scene(rng, n, num_points=16, num_obj_classes=20, num_rel_classes=7)
        out.append({"obj_points": s["obj_points"], "descriptor": s["descriptor"]})
    return out


def _serve(server, scenes):
    with server:
        futs = [server.submit(s) for s in scenes]
        return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("wire,sizes", [
    ("float32", (3, 7, 5, 11, 4, 9)), ("float16", (3, 7, 5, 11, 4, 9)),
    ("float32", (3, 20, 7, 24, 5, 17)),  # mixed sizes padded to bucket 24
], ids=["float32", "float16", "mixed24"])
def test_port_server_matches_jax_server(monkeypatch, wire, sizes):
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", wire)
    fmodel, params, stats, cfg, state = _setup()
    scenes = _scenes(sizes)
    want = _serve(FlaxServer(flax_eval_step(fmodel, branch_3d_only=True), params, stats,
                             max_batch=4, deadline_ms=50.0, num_rel_classes=7), scenes)
    server = BatchedServer(MMGNet(cfg), state, device="cpu", max_batch=4,
                           deadline_ms=50.0, num_rel_classes=7)
    got = _serve(server, scenes)
    assert server.stats["scenes"] == len(scenes)
    assert server.stats["batches"] < len(scenes)
    assert 0 < server.stats["edge_rows"] < server.stats["edge_slots"]  # packed edge rows
    for s, g, w in zip(scenes, got, want):
        n = s["obj_points"].shape[0]
        assert g["obj_logits"].shape == (n, 20)
        assert g["rel_cls"].shape == (n * (n - 1), 7)
        np.testing.assert_array_equal(g["edge_index"], w["edge_index"])
        for key in ("obj_logits", "rel_cls"):
            assert np.isfinite(g[key]).all()
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("branch_key", ["3d", "2d"])
def test_port_server_dual_forward_matches_jax_server(monkeypatch, branch_key):
    """``branch_3d_only=False`` (the runner's default serving forward) with
    either branch's outputs, against the JAX server's ``branch_key``."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    fmodel, params, stats, cfg, state = _setup()
    scenes = _scenes()
    kw = dict(max_batch=4, deadline_ms=50.0, num_rel_classes=7, feat_dim=64,
              branch_key=branch_key)
    want = _serve(FlaxServer(flax_eval_step(fmodel), params, stats, **kw), scenes)
    got = _serve(BatchedServer(MMGNet(cfg), state, device="cpu", branch_3d_only=False, **kw),
                 scenes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["edge_index"], w["edge_index"])
        for key in ("obj_logits", "rel_cls"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL, err_msg=key)


def _expected_edge_rows(batches, max_batch):
    """(rows, slots) of ``batches`` (lists of node counts) padded to
    ``max_batch`` scenes: every valid edge, one row for each scene with
    padded edge rows (an all-zero scene has only those), of max_batch * E."""
    rows = slots = 0
    for counts in batches:
        bucket = pick_bucket(max(counts))
        e = bucket * (bucket - 1)
        rows += sum(n * (n - 1) + (n < bucket) for n in counts) + max_batch - len(counts)
        slots += max_batch * e
    return rows, slots


def test_server_counts_packed_edge_rows():
    """The 3D-only server's step runs its edge layers on the valid edges
    plus one row a scene with padding; ``stats`` and the ``serve.step``
    spans count them against max_batch * E, also where the server is handed
    the step inside a caller's wrapper.  The dual forward runs dense."""
    from vlsat_tpu_torch.train.step import make_eval_step
    from vlsat_tpu_torch.utils import profiling

    _, _, _, cfg, state = _setup()
    sizes = (3, 7, 5, 12, 4, 9)  # queued before the start: batches [3, 7, 5, 12], [4, 9]
    scenes = _scenes(sizes)
    kw = dict(max_batch=4, deadline_ms=200.0, num_rel_classes=7, feat_dim=64)
    inner = make_eval_step(MMGNet(cfg), branch_3d_only=True, device="cpu")

    def wrapped(_state, batch):  # a caller's timing wrapper, as the benchmark's
        return inner(state, batch)

    wrapped.device = inner.device
    servers = {"3d": BatchedServer(MMGNet(cfg), state, device="cpu", **kw),
               "wrapped": BatchedServer(eval_step=wrapped, **kw),
               "dual": BatchedServer(MMGNet(cfg), state, device="cpu", branch_3d_only=False,
                                     **kw)}
    for name, server in servers.items():
        futs = [server.submit(s) for s in scenes]
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), server:
            for f in futs:
                f.result(timeout=120)
        assert server.stats["batches"] == 2, name
        rows, slots = _expected_edge_rows([sizes[:4], sizes[4:]], 4)
        if name == "dual":
            rows = slots
        assert (server.stats["edge_rows"], server.stats["edge_slots"]) == (rows, slots), name
        steps = [sp.attrs for sp in profiling.spans() if sp.name == "serve.step"]
        assert sum(a["edge_rows"] for a in steps) == rows, name
        assert sum(a["edge_slots"] for a in steps) == slots, name


def _wire_reference(scenes, bucket, max_batch, pad_to_max, feat_dim, num_rel):
    """The server's batch as it was built before its buffers were reused:
    ``pad_scene`` a scene, all-zero pad scenes, ``collate``, ``encode_wire``."""
    from vlsat_tpu_torch.data.wire import encode_wire
    from vlsat_tpu_torch.scene import collate, full_edge_index, pad_scene

    padded = []
    for s in scenes:
        n = s["obj_points"].shape[0]
        ei = np.asarray(s.get("edge_index", full_edge_index(n)), np.int32)
        padded.append(pad_scene(
            np.asarray(s["obj_points"], np.float32), np.asarray(s["descriptor"], np.float32),
            np.asarray(s.get("obj_2d_feats", np.zeros((n, feat_dim), np.float32)), np.float32),
            np.zeros((n,), np.int32), ei, np.zeros((len(ei), num_rel), np.float32),
            n_max=bucket, feat_dim=feat_dim))
    if pad_to_max:
        while len(padded) < max_batch:
            padded.append({k: np.zeros_like(v) for k, v in padded[0].items()})
    return encode_wire(collate(padded))


def _request(rng, n, kind, k):
    """A scene of n objects as a client sends it: ``full`` the full graph,
    ``partial`` its own shuffled subset of edges, ``feats`` with 2D features
    on every other request (the dual forward's)."""
    s = make_scene(rng, n, num_points=16, num_obj_classes=20, num_rel_classes=7)
    # wide values, so that the f16 and bf16 roundings differ from f32
    req = {"obj_points": s["obj_points"] * rng.uniform(0.5, 300.0),
           "descriptor": s["descriptor"]}
    if kind == "partial":
        ei = s["edge_index"]
        req["edge_index"] = ei[rng.permutation(len(ei))[:rng.randint(1, len(ei) + 1)]]
    elif kind == "feats" and k % 2 == 0:
        req["obj_2d_feats"] = rng.randn(n, 64).astype(np.float32) * 40.0
    if k % 4 == 2:  # views with negative strides, which numpy assigns as any other
        req = {key: np.flip(np.flip(v, 0).copy(), 0) for key, v in req.items()}
    return req


@pytest.mark.parametrize("kind", ["full", "partial", "feats"])
@pytest.mark.parametrize("pad_to_max", [True, False], ids=["pad_to_max", "ragged"])
@pytest.mark.parametrize("wire", ["float16", "bfloat16", "float32"])
def test_in_place_batch_equals_the_padded_collated_wire_batch(monkeypatch, wire, pad_to_max,
                                                              kind):
    """The server writes each batch into its bucket's reused buffers; every
    field equals (``torch.equal``, same dtype) ``encode_wire(collate(...))``
    of the same scenes padded as before, through sizes growing and shrinking
    in one bucket, slots turning from real to pad and back, and a bucket
    change in between."""
    from vlsat_tpu_torch.scene import SceneBatch
    from vlsat_tpu_torch.utils import profiling

    monkeypatch.setenv("VLSAT_WIRE_DTYPE", wire)

    def step(state, batch):
        raise AssertionError("not called")

    step.device = torch.device("cpu")
    server = BatchedServer(eval_step=step, max_batch=4, feat_dim=64, num_rel_classes=7,
                           pad_to_max=pad_to_max)
    rng = np.random.RandomState(7)
    batches = [(17, 20), (24, 23, 18, 21), (13, 19), (5, 7, 3), (22, 17, 24), (24,),
               (6, 8, 4, 7)]
    for sizes in batches:
        scenes = [_request(rng, n, kind, k) for k, n in enumerate(sizes)]
        with profiling.span("serve.prepare") as sp:
            got, _, counts, _ = server._prepare(scenes, sp)
        bucket = pick_bucket(max(sizes))
        assert got.num_nodes == bucket and counts == list(sizes)
        want = _wire_reference(scenes, bucket, 4, pad_to_max, 64, 7)
        for f in SceneBatch.__dataclass_fields__:
            g, w = getattr(got, f), getattr(want, f)
            if w is None:
                assert g is None, f
                continue
            assert g.dtype == w.dtype and g.is_contiguous(), (f, sizes)
            assert torch.equal(g, w), (f, sizes)
    assert server.stats["wire_buffers"] == 2  # buckets 24 and 8
    assert server.stats["prepared_in_place"] == len(batches) - 2


@pytest.mark.parametrize("pad_to_max", [True, False], ids=["pad_to_max", "ragged"])
def test_no_stale_row_reaches_an_answer(pad_to_max):
    """A batch of large scenes in bucket 24, then one 17-object scene in the
    same bucket: every scene gets the answer a fresh server gives it, bit
    for bit, and the second batch reuses the first one's buffers."""
    torch.manual_seed(0)
    _, _, _, cfg, _ = _setup()
    model = MMGNet(cfg)
    rng = np.random.RandomState(3)
    scenes = [_request(rng, n, "full", k) for k, n in enumerate((24, 22, 23, 21, 17))]
    kw = dict(device="cpu", max_batch=4, deadline_ms=200.0, num_rel_classes=7,
              pad_to_max=pad_to_max)
    server = BatchedServer(model, **kw)
    with server:
        first = [f.result(timeout=120) for f in [server.submit(s) for s in scenes[:4]]]
        last = server.predict(scenes[4], timeout=120)
    assert server.stats["batches"] == 2
    assert server.stats["prepared_in_place"] == 1 and server.stats["wire_buffers"] == 1
    fresh = [_serve(BatchedServer(model, **kw), scenes[:4]), _serve(BatchedServer(model, **kw),
                                                                     scenes[4:])]
    for got, want in zip(first + [last], fresh[0] + fresh[1]):
        for key in ("obj_logits", "rel_cls", "edge_index"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_bench_server_reports_rates():
    _, _, _, cfg, state = _setup()
    server = BatchedServer(MMGNet(cfg), state, device="cpu", max_batch=4,
                           deadline_ms=5.0, num_rel_classes=7)
    with server:
        res = bench_server(server, _scenes(), duration_s=0.5, clients=3)
    assert res["requests"] > 0 and res["scenes_per_sec"] > 0
    assert res["p99_latency_ms"] >= res["p50_latency_ms"] > 0


def test_port_imports_without_jax():
    """With jax, flax and vlsat_tpu blocked, every module of the port
    imports (the walk reaches the eval/, train/, utils/, config/, native/,
    data/, clipsem/, preprocess/, projection/ and tools/ modules, the data
    feed's, the runner's, the CLI's, the SGGpoint family's, the export and
    the offline modules included),
    serves a scene, evaluates two synthetic batches, takes two train
    steps with a checkpoint, and trains one epoch through the CLI
    (``main --mode train --device cpu``) on a synthetic split, on the CPU."""
    code = """
import sys, importlib, pkgutil
for name in ("jax", "jaxlib", "flax", "optax", "vlsat_tpu"):
    sys.modules[name] = None
import numpy as np
import vlsat_tpu_torch
walked = [m.name for m in pkgutil.walk_packages(vlsat_tpu_torch.__path__, "vlsat_tpu_torch.")]
for name in walked:
    importlib.import_module(name)
for name in ("eval.engine", "eval.metrics", "eval.recall", "data.pipeline", "data.synthetic",
             "utils.progbar", "utils.seeding", "train.losses", "train.optim", "train.state",
             "train.step", "train.checkpoint", "interop.from_flax", "config.config",
             "config.defaults", "data.assets", "data.weights", "data.ply", "data.augment",
             "data.sampling", "data.dataset", "data.bucket_batch", "data.packed",
             "data.resident", "native", "main", "train.runner", "models.registry",
             "clipsem.prompts", "clipsem.text_tables", "utils.logging",
             "tools.pack_dataset", "models.variants", "models.mmteacher",
             "interop.torch_import", "ops.dgcnn", "ops.gcn", "models.stn",
             "models.sggpoint", "serving_export", "utils.export", "utils.profiling",
             "preprocess.depth", "preprocess.transform", "preprocess.gen_data",
             "projection.multiview", "data.obj", "clipsem.adapter_train",
             "tools.build_multiview_features", "tools.align_scans", "tools.zero_shot_analysis",
             "tools.build_text_tables", "tools.run_full_pipeline"):
    assert "vlsat_tpu_torch." + name in walked, name
from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
from vlsat_tpu_torch.serving import BatchedServer
cfg = MMGNetConfig(num_obj_classes=5, num_rel_classes=3, point_feature_size=32,
                   dim_node=32, dim_edge=32, dim_atten=16, num_heads=2, clip_feat_dim=32,
                   fused_pointnet=True)
rng = np.random.RandomState(0)
scene = {"obj_points": rng.randn(3, 8, 3).astype(np.float32),
         "descriptor": (np.abs(rng.randn(3, 11)) + 0.1).astype(np.float32)}
with BatchedServer(build_mmgnet(cfg, device="cpu"), device="cpu", max_batch=2,
                   num_rel_classes=3) as server:
    out = server.predict(scene)
assert out["obj_logits"].shape == (3, 5) and np.isfinite(out["rel_cls"]).all()
from vlsat_tpu_torch.data.synthetic import make_batch
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.train.step import make_eval_step
model = build_mmgnet(cfg, device="cpu")
batches = [make_batch(seed=s, node_counts=(3, 4), num_points=8, feat_dim=32,
                      num_obj_classes=5, num_rel_classes=3) for s in range(2)]
metrics = evaluate(make_eval_step(model, device="cpu"), model.state_dict(), batches,
                   num_rel_classes=3, verbose=False, scene_recall=True)
assert "obj_acc_2d_1" in metrics and "sgcls_ngc_recall_20" in metrics
import tempfile
from vlsat_tpu_torch.train.checkpoint import CheckpointManager
from vlsat_tpu_torch.train.optim import make_optimizer
from vlsat_tpu_torch.train.state import create_train_state
from vlsat_tpu_torch.train.step import make_train_step
spec = make_optimizer(lr=1e-3, max_iteration=10)
state = create_train_state(model, spec)
step = make_train_step(model, spec, device="cpu")
batch = make_batch(seed=5, node_counts=(3, 4), num_points=8, feat_dim=32, num_obj_classes=5,
                   num_rel_classes=3)
for i in range(2):
    state, aux = step(state, batch, i)
assert state.step == 2 and bool(aux["loss"].isfinite())
with tempfile.TemporaryDirectory() as d:
    CheckpointManager(d).save(state, eva_res=0.5)
    assert CheckpointManager(d).restore(state, best=True).step == 2
import json, os
from vlsat_tpu_torch.data.synthetic import make_synthetic_split
from vlsat_tpu_torch.main import main
with tempfile.TemporaryDirectory() as d:
    root, scans, cache = make_synthetic_split(os.path.join(d, "split"), num_scans=4,
                                              insts_per_scan=(3, 5), vertices_per_inst=40,
                                              rels_per_scan=3)
    cfg = {"PATH": os.path.join(d, "out"), "MAX_EPOCHES": 1, "Batch_Size": 2,
           "VALID_INTERVAL": 1, "MODEL": {"N_LAYERS": 1, "DIM_ATTEN": 32, "NUM_HEADS": 2},
           "dataset": {"root": root, "scans_root": scans, "cache_root": cache,
                       "num_points": 8}}
    with open(os.path.join(d, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    metrics = main(["--config", os.path.join(d, "cfg.json"), "--mode", "train",
                    "--device", "cpu"])
    assert "mean_recall_50" in metrics
    with open(os.path.join(d, "out", "Mmgnet", "default", "epoch_stats.jsonl")) as f:
        assert json.loads(f.readline())["step"] == 2
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "vlsat_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|vlsat_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((REPO / "vlsat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"
