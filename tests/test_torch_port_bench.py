"""The port's measurement tools (``vlsat_tpu_torch.tools.bench``,
``bench_grouped_eval``, ``bench_buckets``, ``bench_encoders``,
``bench_cold_start``, ``trace_summary``) against ``bench.py`` and the JAX
tools on the same seeded inputs, on the CPU at tiny sizes.

* ``bench``'s helpers equal ``bench.py``'s; its JSON line has
  ``bench.py``'s key set (read from its source) and six link-cost models,
  and ``tools.soak`` reads it.
* Grouped evaluation: the per-batch and K = 4 metrics equal each other and
  JAX ``evaluate()`` over the same pack on the same weights (f32 wire).
* ``bench_buckets``: JAX's row keys, ``"oom"`` cells, the outlier lint.
* ``bench_encoders``' plain encoders against JAX's at the model gate.
* ``bench_cold_start``'s pack equals the JAX tool's byte for byte.
* ``trace_summary`` over a CPU trace of ``utils.profiling.trace()``.
* ``vlsat::pointnet_encode`` counts the plain route's FLOPs.
"""

from __future__ import annotations

import ast
import filecmp
import importlib.util
import json
import math
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from tests.torch_threads import one_thread  # noqa: F401
from vlsat_tpu.data import packed as JPK
from vlsat_tpu.data.synthetic import make_batch as jax_make_batch
from vlsat_tpu.eval.engine import evaluate as jax_evaluate
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu.ops.descriptor import edge_descriptor as jax_edge_descriptor
from vlsat_tpu.ops.descriptor import gen_descriptor as jax_gen_descriptor
from vlsat_tpu.ops.pointnet import pointnet_encode as jax_pointnet_encode
from vlsat_tpu.scene import full_edge_index as jax_full_edge_index
from vlsat_tpu.train.step import make_eval_step as flax_eval_step
from vlsat_tpu_torch.data import bucket_batch
from vlsat_tpu_torch.data.synthetic import make_batch
from vlsat_tpu_torch.interop.from_flax import state_dict_to_flax
from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
from vlsat_tpu_torch.ops.kernels.pointnet_kernel import (pointnet_encode_fused,
                                                         pointnet_encode_fused_v2)
from vlsat_tpu_torch.ops.kernels.segment_max import segment_max, segment_max_plain
from vlsat_tpu_torch.ops.pointnet import pointnet_encode
from vlsat_tpu_torch.tools import bench, bench_buckets, bench_cold_start, bench_encoders
from vlsat_tpu_torch.tools import bench_grouped_eval, soak, trace_summary
from vlsat_tpu_torch.utils.profiling import compiled_flops, trace

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-3, 1e-4
# narrow enough for the CPU; the 2D features and the mimic target stay 512 wide
WIDTHS = dict(point_feature_size=512, dim_node=512, dim_edge=64, dim_atten=32, num_heads=4,
              depth=1)
CFG = MMGNetConfig(**WIDTHS)
TINY = dict(NODE_COUNTS=(5, 7, 9, 12), BUCKET=12, NUM_POINTS=16, EVAL_CALLS=2, TRAIN_CALLS=2,
            LATENCY_CALLS=5, LATENCY_NODES=9, SPLIT_SCANS=8, VERTS_PER_INST=60, MIX_SCANS=10,
            EVAL_B=4, B_TR=2, K=2, K_MIX=1, SERV_DURATION=0.5, SERV_CLIENTS=4)


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    for name, value in TINY.items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setattr(bench, "model_config", lambda: CFG)
    # the bucket mix's eval batches, which pad to 32 / 64 scenes at full size
    monkeypatch.setattr(bucket_batch, "DEFAULT_EVAL_BATCH",
                        {**bucket_batch.DEFAULT_EVAL_BATCH, 8: 4, 12: 4})
    monkeypatch.setenv("VLSAT_BENCH_E2E_REPS", "1")
    monkeypatch.setenv("VLSAT_BENCH_SPLIT", str(tmp_path / "split"))
    monkeypatch.setenv("VLSAT_BENCH_MIX_SPLIT", str(tmp_path / "mix"))
    return tmp_path


def _load(name: str, path: Path):
    """A repo-root script as a module, without putting its folder on sys.path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- the helpers

def test_link_models_equal_bench():
    rng = np.random.RandomState(0)
    for _ in range(50):
        link = {"rtt_ms": float(rng.uniform(0.01, 40)), "h2d_MBps": float(rng.uniform(20, 25e3)),
                "d2h_MBps": float(rng.uniform(20, 25e3))}
        kw = dict(unit_scenes=float(rng.randint(1, 600)), rate=float(rng.uniform(1, 5e3)),
                  link=link, n_rtt=float(rng.randint(0, 40)),
                  h2d_bytes=float(rng.randint(0, 10**8)), d2h_bytes=float(rng.randint(0, 10**7)))
        for best in (None, kw["rate"] * float(rng.uniform(1.0, 1.3))):
            assert bench.link_cost_model(**kw, rate_best=best) == \
                jax_bench.link_cost_model(**kw, rate_best=best)
        model = bench.link_cost_model(**kw)
        for state in ((link["rtt_ms"], link["h2d_MBps"], link["d2h_MBps"]),
                      (float(rng.uniform(0, 50)), float(rng.uniform(1, 1e4)), None)):
            assert bench.predict_rate(model, *state) == jax_bench.predict_rate(model, *state)
    assert soak.predict_rate is bench.predict_rate  # one copy


@pytest.mark.parametrize("b,n,e,cap", [(32, 16, 240, 3), (1, 8, 56, 1), (64, 12, 132, 5),
                                       (7, 4, 12, 2)])
def test_packed_d2h_bytes_equal_bench(b, n, e, cap):
    for tags in (1, 2):
        assert bench.packed_d2h_bytes(b, n, e, cap, tags) == \
            jax_bench.packed_d2h_bytes(b, n, e, cap, tags)


@pytest.mark.parametrize("with_text", [False, True])
def test_tree_nbytes_equals_bench(with_text):
    kw = dict(seed=3, node_counts=(5, 9, 12), num_points=16, bucket=12, with_text=with_text)
    port, jax_b = make_batch(**kw), jax_make_batch(**kw)
    both = [f for f, v in vars(port).items()
            if v is not None and getattr(jax_b, f, None) is not None]
    assert {"obj_points", "descriptor", "edge_index", "gt_rels"} <= set(both)
    port = port.replace(**{f: None for f in vars(port) if f not in both})
    jax_b = jax_b.replace(**{f: None for f in vars(port) if f not in both
                             and hasattr(jax_b, f)})
    assert bench.tree_nbytes(port) == jax_bench.tree_nbytes(jax_b)


@pytest.mark.parametrize("b3d", [False, True], ids=["dual", "3d_only"])
def test_eval_many_equals_bench(b3d):
    """The carry-chained eval of ``bench.py`` (``make_eval_many``) on the same
    weights and batch: the carry after 2 calls at the model gate."""
    model = build_mmgnet(CFG, "cpu", seed=0)
    batch_kw = dict(seed=4, node_counts=(5, 7), num_points=16, bucket=8)
    got = bench.make_eval_many(model, "cpu")(model.state_dict(), make_batch(**batch_kw), 2,
                                             b3d=b3d)
    params, stats = state_dict_to_flax(model.state_dict())
    want = jax_bench.make_eval_many(FlaxMMGNet(cfg=FlaxConfig(**WIDTHS)))(
        params, stats, jax_make_batch(**batch_kw), 2, b3d=b3d)
    np.testing.assert_allclose(float(got) * 1e30, float(want) * 1e30, rtol=RTOL)


def _bench_keys() -> set:
    """The keys of the dict ``bench.py`` prints, from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" \
                and node.args and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in bench.py")


def test_bench_main_on_cpu(tiny_bench, capsys):
    out = tiny_bench / "bench.json"
    res = bench.main(["--device", "cpu", "--out", str(out)])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(out.read_text())
    keys = _bench_keys()
    assert len(keys) == 32 and set(res) == keys
    fields = {"unit_scenes", "n_rtt", "h2d_bytes", "d2h_bytes", "t_nolink_s", "link",
              "measured_median", "predicted_here"}
    models = res["link_cost_models"]
    assert set(models) == {"eval_e2e_scenes_per_sec", "eval_e2e_streaming_scenes_per_sec",
                           "train_e2e_scenes_per_sec", "eval_e2e_bucketmix_scenes_per_sec",
                           "train_e2e_bucketmix_scenes_per_sec", "serving_scenes_per_sec"}
    for name, m in models.items():
        assert fields <= set(m), name
        assert set(m["link"]) == {"rtt_ms", "h2d_MBps", "d2h_MBps"}, name
    assert {"h2d_bytes_f32"} <= set(models["eval_e2e_streaming_scenes_per_sec"])
    assert {"h2d_bytes_f32"} <= set(models["serving_scenes_per_sec"])
    assert models["eval_e2e_bucketmix_scenes_per_sec"]["batch_sizes"]
    rates = [k for k in res if k.endswith("scenes_per_sec") or k == "value"]
    assert len(rates) == 9
    for k in rates:
        assert math.isfinite(res[k]) and res[k] > 0, (k, res[k])
    # the CPU has no card peak: no MFU is reported
    assert all(res[k] is None for k in res if k.endswith("_mfu"))
    got = soak.bench_prediction(str(out), 100.0)
    assert "error" not in got and got["predicted_scenes_per_sec"] > 0


@pytest.mark.parametrize("tool", [bench, bench_grouped_eval, bench_buckets, bench_encoders])
def test_tools_need_a_card(tool):
    """The card is the default device; without one the tools raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


# ------------------------------------------------------ grouped evaluation

def test_grouped_eval_equals_jax(tiny_bench, monkeypatch, capsys):
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    monkeypatch.setattr(bench_grouped_eval, "GROUPS", (4,))
    monkeypatch.setattr(bench_grouped_eval, "EVAL_B", 3)
    res = bench_grouped_eval.main(["--device", "cpu", "--reps", "1"])
    assert [r["group"] for r in res["rows"]] == [1, 4]
    assert res["rows"][1]["metrics_equal"] and res["scenes"] == TINY["SPLIT_SCANS"]
    params, stats = state_dict_to_flax(build_mmgnet(CFG, "cpu", seed=0).state_dict())
    jcfg = FlaxConfig(**WIDTHS)
    want = jax_evaluate(flax_eval_step(FlaxMMGNet(cfg=jcfg)), params, stats,
                        JPK.PackedLoader(JPK.PackedScenes(str(tiny_bench / "split" / "pack")),
                                         batch_size=3), verbose=False)
    got = res["metrics"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = float(got[k])
        assert (np.isnan(g) and np.isnan(w)) or g == w, (k, g, w)


def test_rank_mismatches_count_entries():
    a = {"x": np.arange(6).reshape(2, 3), "y": np.zeros(4)}
    b = {"x": np.array([[0, 1, 9], [3, 4, 5]]), "y": np.ones(4)}
    assert bench_grouped_eval.rank_mismatches(a, a) == (0, 10)
    assert bench_grouped_eval.rank_mismatches(b, a) == (5, 10)
    with pytest.raises(ValueError):
        bench_grouped_eval.rank_mismatches({"x": a["x"]}, a)


# ----------------------------------------------------------- bucket table

def _jax_row_keys() -> dict:
    """Per mode, the keys ``tools/bench_buckets.py`` puts in a measured row
    (its ``row = {...}`` and ``row.update(...)``)."""
    tree = ast.parse((REPO / "tools" / "bench_buckets.py").read_text())
    keys = {}
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name in ("measure_eval", "measure_train"):
            got = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                        getattr(node.targets[0], "id", "") == "row":
                    got |= {k.value for k in node.value.keys}
                if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update":
                    got |= {kw.arg for kw in node.keywords}
            keys[fn.name] = got
    return keys


@pytest.fixture(scope="module")
def cells():
    return bench_buckets.Cells(torch.device("cpu"), reps=1, cfg=CFG)


def test_bucket_rows_have_jax_keys(cells):
    want = _jax_row_keys()
    assert len(want["measure_eval"]) == 10 and len(want["measure_train"]) == 11
    eval_row = cells.measure_eval(8, 2)
    train_row = cells.measure_train(8, 2)
    assert set(eval_row) == want["measure_eval"], eval_row
    assert set(train_row) == want["measure_train"], train_row
    assert eval_row["eval_gflops"] > 0 and eval_row["eval_slope_n_hi"] >= bench_buckets.N_MIN
    assert train_row["train_gflops"] > eval_row["eval_gflops"] > 0
    assert eval_row["eval_mfu"] is None and train_row["train_mfu"] is None  # no card peak


def test_bucket_cell_out_of_memory(cells, monkeypatch):
    def oom(*_, **__):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 70.00 GiB")

    monkeypatch.setattr(bench_buckets, "scene_batch", oom)
    assert cells.measure_eval(64, 64) == {"bucket": 64, "batch": 64, "edges": 4032,
                                          "eval_error": "oom"}
    assert cells.measure_train(64, 64)["train_error"] == "oom"
    monkeypatch.setattr(bench_buckets, "scene_batch",
                        lambda *_, **__: (_ for _ in ()).throw(ValueError("bad bucket")))
    assert cells.measure_eval(8, 2)["eval_error"] == "bad bucket"


def test_bucket_lint_remeasures_out_of_family_cells():
    ev = lambda bucket, b, mfu: {"bucket": bucket, "batch": b, "eval_mfu": mfu}
    tr = lambda bucket, b, mfu: {"bucket": bucket, "batch": b, "mode": "train", "train_mfu": mfu}
    rows = [ev(8, 2, 0.10), ev(8, 4, 0.11), ev(8, 8, 0.12), ev(8, 16, 0.105),
            ev(8, 32, 0.50),                     # > 2x its family's median: flagged
            ev(12, 4, 0.20), ev(12, 8, 0.21), ev(12, 16, 0.22),
            ev(12, 32, 0.05),                    # < half its family's median: flagged
            {"bucket": 12, "batch": 64, "eval_error": "oom"},
            tr(8, 4, 0.30), tr(8, 8, 0.31), tr(8, 16, None)]
    flagged = bench_buckets.lint(rows)
    assert [(r["bucket"], r["batch"], mode) for r, mode, _, _ in flagged] == \
        [(8, 32, "eval"), (12, 32, "eval")]
    calls = []

    def measure_eval(bucket, b):
        calls.append(("eval", bucket, b))
        return {"bucket": bucket, "batch": b, "eval_mfu": 0.105 if bucket == 8 else 0.05}

    def measure_train(bucket, b):
        raise AssertionError("no train cell is out of family")

    fresh = bench_buckets.remeasure_outliers(rows, measure_eval, measure_train)
    assert calls == [("eval", 8, 32), ("eval", 12, 32)] and len(fresh) == 2
    assert "eval_remeasured" in rows[4] and "eval_outlier" not in rows[4]
    assert "eval_outlier" in rows[8] and "persists" in rows[8]["eval_outlier"]
    assert len(rows) == 13 and rows[4] is fresh[0] and rows[8] is fresh[1]


# --------------------------------------------------------------- encoders

def test_encoders_equal_jax():
    scenes, nodes, points = 3, 5, 16
    inp = bench_encoders.encoder_inputs(scenes, nodes, points)
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    pts = torch.from_numpy(inp["pts"])
    got = bench_encoders.object_encoder(pts, t(inp["ws"]), t(inp["bs"]), fused=False)
    want = jax_pointnet_encode(jnp.asarray(inp["pts"]), [jnp.asarray(w) for w in inp["ws"]],
                               [jnp.asarray(b) for b in inp["bs"]])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    fused = bench_encoders.object_encoder(pts, t(inp["ws"]), t(inp["bs"]), fused=True)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())  # the CPU runs the twin

    ei = np.broadcast_to(jax_full_edge_index(nodes)[None],
                         (scenes, nodes * (nodes - 1), 2)).copy()
    got = bench_encoders.relation_encoder(pts, torch.from_numpy(ei), t(inp["ws_r"]),
                                          t(inp["bs_r"]), scenes, nodes)
    desc = jax_gen_descriptor(jnp.asarray(inp["pts"]).reshape(scenes, nodes, points, 3))
    want = jax_pointnet_encode(jax_edge_descriptor(desc, jnp.asarray(ei))[..., None, :],
                               [jnp.asarray(w) for w in inp["ws_r"]],
                               [jnp.asarray(b) for b in inp["bs_r"]])
    assert got.shape == (scenes, nodes * (nodes - 1), 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_encoders_main_on_cpu(capsys):
    res = bench_encoders.main(["--device", "cpu", "--scenes", "3", "--nodes", "5",
                               "--points", "16"])
    assert res["instances"] == 15 and res["object_encoder"]["within_gate"]
    assert res["object_encoder"]["max_abs_err"] == 0.0
    assert res["relation_encoder"]["edges"] == 60
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"encoders": res}


# ------------------------------------------------------------- cold start

def test_cold_start_pack_equals_jax_tool(tmp_path, monkeypatch):
    args = ["--num-scans", "6", "--verts-per-inst", "200", "--background-verts", "300",
            "--batch-size", "2", "--keep"]
    got = bench_cold_start.main(args + ["--base", str(tmp_path / "port")])
    jax_tool = _load("jax_bench_cold_start", REPO / "tools" / "bench_cold_start.py")
    out = tmp_path / "jax.json"
    monkeypatch.setattr("sys.argv", ["bench_cold_start.py", *args, "--base",
                                     str(tmp_path / "jax"), "--out", str(out)])
    jax_tool.main()
    want = json.loads(out.read_text())
    assert set(got) == set(want)
    assert got["pack_bytes"] == want["pack_bytes"] > 0
    port_pack, jax_pack = tmp_path / "port" / "packed", tmp_path / "jax" / "packed"
    names = sorted(os.listdir(jax_pack))
    assert sorted(os.listdir(port_pack)) == names and "manifest.json" in names
    match, mismatch, errors = filecmp.cmpfiles(jax_pack, port_pack, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


# ---------------------------------------------------------- trace summary

def test_trace_summary_of_a_cpu_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("VLSAT_PROFILE_DIR", str(tmp_path))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 64, generator=g)
    data = torch.randn(2, 12, 8, generator=g)
    ei = torch.randint(0, 4, (2, 12, 2), generator=g, dtype=torch.int32)
    em = torch.ones(2, 12, dtype=torch.bool)
    with trace() as path:
        for _ in range(3):
            torch.softmax(x @ x.T, -1).sum()
            segment_max(data, ei, em, 4)
    full = trace_summary.summarize(path, cat="cpu_op")
    assert math.isclose(sum(full["categories"].values()), full["total_us"], rel_tol=1e-9)
    assert full["total_us"] > 0
    for cat in ("vlsat segment-max / PointNet", "GEMMs", "softmax", "reductions"):
        assert full["categories"].get(cat, 0) > 0, (cat, full["categories"])
    ops = {r["name"]: r for r in full["top"]}
    assert ops["vlsat::segment_max"]["calls"] == 3
    per = trace_summary.main([str(tmp_path), "--cat", "cpu_op", "--iters", "3"])
    assert per["trace"] == path
    assert math.isclose(per["total_us"] * 3, full["total_us"], rel_tol=1e-9)
    for k, v in full["categories"].items():
        assert math.isclose(per["categories"][k] * 3, v, rel_tol=1e-9)
    # a CPU trace has no kernel events
    assert trace_summary.summarize(path)["total_us"] == 0


@pytest.mark.parametrize("name,cat", [
    ("segment_max_kernel(float const*, int const*, unsigned char const*, float*, int, int, "
     "int, int, int)", "vlsat segment-max / PointNet"),
    ("pointnet_kernel(float const*, float const*)", "vlsat segment-max / PointNet"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "GEMMs"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>", "GEMMs"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "softmax"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reductions"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "copies"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>", "other"),
])
def test_trace_categories(name, cat):
    assert trace_summary.categorize(name) == cat


def test_self_times_subtract_nested_events():
    ev = [{"name": "a", "ts": 0, "dur": 10, "tid": 1}, {"name": "b", "ts": 2, "dur": 3, "tid": 1},
          {"name": "c", "ts": 5, "dur": 5, "tid": 1}, {"name": "d", "ts": 9, "dur": 4, "tid": 1},
          {"name": "e", "ts": 1, "dur": 20, "tid": 2}]
    assert sorted(trace_summary.self_times(ev)) == \
        [("a", 2.0), ("b", 3.0), ("c", 5.0), ("d", 4.0), ("e", 20.0)]


# ------------------------------------------------------------------- FLOPs

def test_pointnet_operator_counts_the_plain_flops():
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(64, 128, 3, generator=g)
    dims = (3, 64, 128, 768)
    ws = [torch.randn(a, b, generator=g) * 0.1 for a, b in zip(dims, dims[1:])]
    bs = [torch.zeros(b) for b in dims[1:]]
    plain = compiled_flops(pointnet_encode, pts, ws, bs)
    assert plain == 2 * 64 * 128 * (3 * 64 + 64 * 128 + 128 * 768) == 1_747_976_192
    assert compiled_flops(pointnet_encode_fused, pts, ws, bs) == plain
    assert compiled_flops(pointnet_encode_fused_v2, pts, ws, bs) == plain
    assert compiled_flops(pointnet_encode_fused, pts.reshape(2, 32, 128, 3), ws, bs) == plain
    data = torch.randn(2, 12, 8, generator=g)
    ei = torch.randint(0, 4, (2, 12, 2), generator=g, dtype=torch.int32)
    em = torch.ones(2, 12, dtype=torch.bool)
    assert compiled_flops(segment_max, data, ei, em, 4) == \
        compiled_flops(segment_max_plain, data, ei, em, 4) == 0
