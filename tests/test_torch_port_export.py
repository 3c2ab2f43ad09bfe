"""The port's deployment artifacts on the CPU: ``serving_export`` (the cases
of tests/test_serving_export.py), ``utils.export`` and ``main --mode
trace`` (tests/test_export.py's), ``utils.profiling``, and the two kernels
as PyTorch operators (``vlsat::segment_max``, ``vlsat::pointnet_encode``).

Gates: an artifact against the live eval step at rtol/atol 1e-6, as in
JAX; the exported program against eager execution at JAX's export gate
(rtol 1e-3, atol 1e-5); the operators' gradients equal to the plain
autograd's (the backward is the plain twin's at the same primal).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_port_runner import mini, write_config  # noqa: F401
from vlsat_tpu_torch.data.synthetic import make_batch
from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
from vlsat_tpu_torch.ops.pointnet import pointnet_encode
from vlsat_tpu_torch.serving import BatchedServer
from vlsat_tpu_torch.serving_export import export_serving_artifact, load_serving_artifact
from vlsat_tpu_torch.train.step import make_eval_step
from vlsat_tpu_torch.utils import profiling
from vlsat_tpu_torch.utils.export import export_and_check, trace_model

BUCKET, BATCH, POINTS = 4, 4, 8
# the narrow flagship of tests/test_torch_port_model.py, with the fused
# PointNet route, so that both operators are inside the program
CFG = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64, dim_node=64,
                   dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64,
                   fused_pointnet=True)
KW = dict(num_points=POINTS, feat_dim=CFG.clip_feat_dim, num_obj_classes=20, num_rel_classes=7)


def batch(seed, counts, bucket=BUCKET, **kw):
    return make_batch(seed=seed, node_counts=counts, bucket=bucket, **{**KW, **kw})


@pytest.fixture(scope="module")
def model():
    return build_mmgnet(CFG, device="cpu", seed=0)


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("artifact"))
    manifest = export_serving_artifact(model, out, buckets=(BUCKET,), max_batch=BATCH,
                                       num_points=POINTS, feat_dim=CFG.clip_feat_dim,
                                       device="cpu")
    return out, manifest


def test_manifest_contract(artifact):
    out, manifest = artifact
    assert manifest["outputs"] == ["obj_logits_3d", "rel_cls_3d"]
    assert manifest["max_batch"] == BATCH and manifest["branch_3d_only"] is True
    assert set(manifest["buckets"]) == {str(BUCKET)}
    assert manifest["platforms"] == ["cpu"] and manifest["format_version"] == 1
    assert (manifest["num_points"], manifest["point_dim"], manifest["feat_dim"],
            manifest["num_rel_classes"]) == (POINTS, 3, CFG.clip_feat_dim, 7)
    with open(os.path.join(out, "manifest.json")) as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(manifest))
    assert os.path.getsize(os.path.join(out, manifest["buckets"][str(BUCKET)]["file"])) > 0


def test_roundtrip_matches_live_eval_step(model, artifact):
    """The program holds both operators; its outputs equal the live 3D-only
    eval step's (f16 wire batch in both)."""
    loaded = load_serving_artifact(artifact[0], device="cpu")
    code = loaded._programs[BUCKET].code
    assert "vlsat.segment_max" in code and "vlsat.pointnet_encode" in code
    b = batch(3, (3, 4, 2, 4))
    live = make_eval_step(model, branch_3d_only=True, device="cpu")(model.state_dict(), b)
    frozen = loaded(None, b)
    assert set(frozen) == {"obj_logits_3d", "rel_cls_3d"}
    for k in frozen:
        np.testing.assert_allclose(frozen[k].numpy(), live[k].numpy(), rtol=1e-6, atol=1e-6)


def test_exported_step_drives_batched_server(model, artifact):
    loaded = load_serving_artifact(artifact[0], device="cpu")
    rng = np.random.RandomState(0)
    scenes = []
    for n in (3, 4, 2):
        pts = rng.randn(n, POINTS, 3).astype(np.float32)
        scenes.append({"obj_points": pts - pts.mean(axis=1, keepdims=True),
                       "descriptor": np.abs(rng.randn(n, 11)).astype(np.float32) + 0.1,
                       "obj_2d_feats": rng.randn(n, CFG.clip_feat_dim).astype(np.float32)})
    kw = dict(max_batch=BATCH, deadline_ms=1.0, buckets=(BUCKET,), feat_dim=CFG.clip_feat_dim,
              num_rel_classes=7)
    with BatchedServer(model, device="cpu", **kw) as srv:
        live = [srv.predict(s, timeout=300.0) for s in scenes]
    with BatchedServer(eval_step=loaded, **kw) as srv:
        frozen = [srv.predict(s, timeout=300.0) for s in scenes]
    for a, b in zip(live, frozen):
        assert a["obj_logits"].shape == b["obj_logits"].shape
        np.testing.assert_allclose(a["obj_logits"], b["obj_logits"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a["rel_cls"], b["rel_cls"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(a["edge_index"], b["edge_index"])
    with pytest.raises(ValueError, match="not both"):
        BatchedServer(model, eval_step=loaded)


def test_shape_validation_errors(artifact):
    loaded = load_serving_artifact(artifact[0], device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        loaded(None, batch(1, (5,) * BATCH, bucket=8))
    with pytest.raises(ValueError, match="batch"):
        loaded(None, batch(1, (3, 4)))
    with pytest.raises(ValueError, match="points"):
        loaded(None, batch(1, (3,) * BATCH, num_points=POINTS * 2))


def test_wrong_device_and_format_are_refused(artifact, tmp_path):
    """A CPU artifact does not load for the card, and an unknown format
    does not load at all."""
    out, manifest = artifact
    with pytest.raises((ValueError, RuntimeError), match="cpu|CUDA"):
        load_serving_artifact(out, device="cuda")
    bad = dict(manifest, platforms=["cuda"])
    (tmp_path / "manifest.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="exported for"):
        load_serving_artifact(str(tmp_path), device="cpu")
    (tmp_path / "manifest.json").write_text(json.dumps(dict(manifest, format_version=9)))
    with pytest.raises(ValueError, match="format"):
        load_serving_artifact(str(tmp_path), device="cpu")


def test_full_branch_export_outputs_2d(model, tmp_path):
    manifest = export_serving_artifact(model, str(tmp_path), buckets=(BUCKET,), max_batch=2,
                                       num_points=POINTS, feat_dim=CFG.clip_feat_dim,
                                       branch_3d_only=False, device="cpu")
    assert set(manifest["outputs"]) == {"obj_logits_3d", "rel_cls_3d", "obj_logits_2d",
                                        "rel_cls_2d"}
    b = batch(5, (4, 3))
    out = load_serving_artifact(str(tmp_path), device="cpu")(None, b)
    live = make_eval_step(model, device="cpu")(model.state_dict(), b)
    assert out["obj_logits_2d"].shape == out["obj_logits_3d"].shape
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), live[k].numpy(), rtol=1e-6, atol=1e-6)


def test_loader_imports_no_model_module(artifact):
    """A fresh interpreter loads and runs the artifact with every module of
    ``vlsat_tpu_torch.models`` (and JAX) blocked."""
    code = f"""
import sys
for name in ("jax", "flax", "vlsat_tpu", "vlsat_tpu_torch.models"):
    sys.modules[name] = None
from vlsat_tpu_torch.data.synthetic import make_batch
from vlsat_tpu_torch.serving_export import load_serving_artifact
step = load_serving_artifact({artifact[0]!r}, device="cpu")
out = step(None, make_batch(seed=3, node_counts=(3, 4, 2, 4), bucket={BUCKET},
                            **{KW!r}))
assert out["obj_logits_3d"].shape == ({BATCH}, {BUCKET}, 20)
assert not [m for m in sys.modules if m.startswith("vlsat_tpu_torch.models.")]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


# ------------------------------------------------------ export and trace

def test_export_and_check_roundtrip(tmp_path):
    """tests/test_export.py's toy function at two shapes."""
    def fn(x, w):
        return torch.tanh(x @ w).sum(dim=-1)

    rng = np.random.RandomState(0)
    small = (torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
             torch.from_numpy(rng.randn(8, 8).astype(np.float32)))
    large = (torch.from_numpy(rng.randn(16, 8).astype(np.float32)),
             torch.from_numpy(rng.randn(8, 8).astype(np.float32)))
    report = export_and_check(fn, small, large, str(tmp_path), "toy")
    assert report["checked_small"] and report["checked_large"]
    assert os.path.exists(report["program_small"]) and os.path.exists(report["program_large"])
    text = (tmp_path / "toy.small.graph.txt").read_text()
    assert "aten.tanh" in text and "def forward" in text
    program = torch.export.load(report["program_large"]).module()
    torch.testing.assert_close(program(*large), fn(*large), rtol=1e-6, atol=1e-6)


def test_export_and_check_catches_a_wrong_program(tmp_path):
    """The check compares: a Python-side constant that export bakes in at
    trace time, and eager execution draws anew, fails it."""
    rng = np.random.RandomState(0)
    x = (torch.ones(2, 3),)
    with pytest.raises(AssertionError):
        export_and_check(lambda a: a + float(rng.rand()), x, x, str(tmp_path), "drift")


def test_trace_model_on_flagship(model, tmp_path):
    """tests/test_export.py:29's case: a runner-shaped object holding the
    model on the CPU."""
    class FakeRunner:
        pass

    r = FakeRunner()
    r.model, r.device = model, torch.device("cpu")
    report = trace_model(r, str(tmp_path))
    assert report["checked_small"] and report["checked_large"]
    assert os.path.exists(report["program_small"])


def test_cli_trace_mode_exports_the_registry_model(mini, tmp_path):  # noqa: F811
    """``main --mode trace --device cpu`` on a JSON of the runner tests:
    two programs and their graphs under PATH/NAME/exp/traced."""
    from vlsat_tpu_torch.main import main

    _, paths = mini
    path = write_config(tmp_path / "cfg.json", paths["unpacked"], PATH=str(tmp_path / "out"))
    report = main(["--config", path, "--mode", "trace", "--device", "cpu"])
    traced = tmp_path / "out" / "Mmgnet" / "default" / "traced"
    assert report["checked_small"] and report["checked_large"]
    assert sorted(p.name for p in traced.iterdir()) == [
        "mmgnet_eval.large.graph.txt", "mmgnet_eval.large.pt2",
        "mmgnet_eval.small.graph.txt", "mmgnet_eval.small.pt2"]


# ------------------------------------------------------------- profiling

def test_profiling_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("VLSAT_PROFILE_DIR", str(tmp_path))
    with profiling.trace() as path:
        with profiling.annotate("work"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "work" in names and "aten::mm" in names
    monkeypatch.delenv("VLSAT_PROFILE_DIR")
    with profiling.trace() as path:
        pass
    assert path is None and len(os.listdir(tmp_path)) == 1


def test_flop_counter_counts_a_linear_exactly():
    lin = torch.nn.Linear(16, 8)
    x = torch.randn(5, 16)
    assert profiling.compiled_flops(lin, x) == 2 * 5 * 16 * 8


def test_peak_flops_is_h100_only(monkeypatch):
    monkeypatch.delenv("VLSAT_PEAK_TFLOPS", raising=False)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA H100 NVL", 835e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert profiling.peak_flops_per_sec() == peak
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "TPU v5 lite")
    with pytest.raises(ValueError, match="VLSAT_PEAK_TFLOPS"):
        profiling.peak_flops_per_sec()
    monkeypatch.setenv("VLSAT_PEAK_TFLOPS", "100")
    assert profiling.peak_flops_per_sec() == 100e12


# ------------------------------------------------------------- operators

def test_operators_pass_opcheck():
    """Schema, fake (shapes and strides), autograd registration and
    dispatch of both operators (``torch.library.opcheck``)."""
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(2, 6, 4).astype(np.float32)).requires_grad_()
    ei = torch.from_numpy(rng.randint(0, 3, (2, 6, 2)).astype(np.int32))
    em = torch.from_numpy(rng.rand(2, 6) > 0.3)
    for target in (0, 1):
        torch.library.opcheck(torch.ops.vlsat.segment_max.default, (data, ei, em, 3, target))
    pts = torch.randn(2, 3, 8, 3, requires_grad=True)
    ws = [torch.randn(8, 3, requires_grad=True).t(), torch.randn(16, 8).t(),
          torch.randn(8, 16, requires_grad=True).t()]
    bs = [torch.randn(8), torch.randn(16, requires_grad=True), torch.randn(8)]
    for p_chunk in (0, 4):
        torch.library.opcheck(torch.ops.vlsat.pointnet_encode.default, (pts, *ws, *bs, p_chunk))


def test_operator_gradients_equal_plain_autograd():
    """The operators' backward (the plain twin's gradient at the same
    primal) against autograd through the plain functions, bit for bit on
    the CPU; and no launch is counted on the CPU."""
    rng = np.random.RandomState(1)
    before = (segment_max.launches, pointnet_kernel.launches)
    data = torch.from_numpy(rng.randn(3, 12, 5).astype(np.float32))
    ei = torch.from_numpy(rng.randint(0, 4, (3, 12, 2)).astype(np.int32))
    em = torch.from_numpy(rng.rand(3, 12) > 0.3)
    g_out = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
    grads = []
    for fn in (segment_max.segment_max, segment_max.segment_max_plain):
        d = data.clone().requires_grad_()
        out = fn(d, ei, em, 4, 1)
        (g,) = torch.autograd.grad(out, d, g_out)
        grads.append((out.detach(), g))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])

    pts = torch.from_numpy(rng.randn(2, 3, 8, 3).astype(np.float32))
    ws = [torch.from_numpy(rng.randn(o, i).astype(np.float32)) for i, o in
          ((3, 8), (8, 16), (16, 8))]
    bs = [torch.from_numpy(rng.randn(o).astype(np.float32)) for o in (8, 16, 8)]
    g_out = torch.from_numpy(rng.randn(2, 3, 8).astype(np.float32))
    results = []
    for fn in (pointnet_kernel.pointnet_encode_fused,
               lambda p, w, b: pointnet_kernel.pointnet_encode_fused_v2(p, w, b, p_chunk=4),
               pointnet_encode):
        leaves = [t.clone().requires_grad_() for t in (pts, *ws, *bs)]
        out = fn(leaves[0], [w.t() for w in leaves[1:4]], leaves[4:])
        results.append((out.detach(), torch.autograd.grad(out, leaves, g_out)))
    for got in results[:2]:
        assert torch.equal(got[0], results[2][0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], results[2][1]))
    assert (segment_max.launches, pointnet_kernel.launches) == before
