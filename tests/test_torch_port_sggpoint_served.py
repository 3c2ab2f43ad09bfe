"""SGGpoint served 3D only, on the CPU: the port (the registry's model
loaded through ``interop.torch_import.import_sggpoint``) against the
benchmark's plain reference ``benchmark/reference/sggpoint.py`` on its
seeded weights in the original checkpoint layout, the 3D-only forward
against the dual forward, the import's layout, ``BatchedServer`` over the
model, the ``model.dgcnn`` span and the server's instance counters, the
models without a 3D-only mode, and the LayerNorm epsilon of each build.

The reference is given the neighbour sets that the port chose (recorded
from ``ops.dgcnn.knn_indices``), and each set is held to be a true float64
kNN, so the comparison does not hang on near-ties.  Gate of the float64
comparisons: 1e-6, set by the port's GCN degree coefficients, which it
computes in fp32 whatever the features' dtype (``ops/gcn.py``); the rest
of the forward agrees to ~1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

from benchmark.harness import scenes
from benchmark.harness.weights import build_reference
from benchmark.reference import plain
from benchmark.reference import sggpoint as R
from tests.torch_threads import one_thread  # noqa: F401
from vlsat_tpu_torch.config import load_config
from vlsat_tpu_torch.interop import torch_import
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from vlsat_tpu_torch.models.registry import build_model
from vlsat_tpu_torch.models.sggpoint import SGGpoint, SGGpointConfig
from vlsat_tpu_torch.models.transformer import FLAX_LN_EPS, TORCH_LN_EPS
from vlsat_tpu_torch.ops import dgcnn
from vlsat_tpu_torch.scene import collate, pad_scene
from vlsat_tpu_torch.serving import BatchedServer
from vlsat_tpu_torch.train.step import has_3d_only_mode, make_eval_step, take_instances
from vlsat_tpu_torch.utils import profiling

GATE = dict(rtol=1e-6, atol=1e-6)
POINTS = 32
SEED = 2300000011


def _mcfg(**model):
    return load_config(overrides={"MODEL": model}).MODEL


def _port_and_reference(dim, heads, k, seed=SEED, dtype=torch.float64):
    """The reference drawn from ``seed``, and the port loaded from its
    checkpoint layout: the registry's model at dim 512, else the model of
    ``SGGpointConfig`` at ``dim`` with torch's epsilon."""
    ref = build_reference(R.SGGpointReference, torch.device("cpu"), seed, dim=dim, heads=heads,
                          k=k)
    layout = R.module_state_dicts(ref)
    if dim == 512:
        model, _ = build_model("SGGpoint", 160, 26, _mcfg(NUM_HEADS=heads))
        assert model.backbone.k == k
    else:
        model = SGGpoint(SGGpointConfig(dim=dim, num_heads=heads, knn_k=k,
                                        ln_eps=TORCH_LN_EPS))
    model.load_state_dict(torch_import.to_state_dict(torch_import.import_sggpoint(layout), model))
    return model.to(dtype).eval(), ref.to(dtype).eval(), layout


def _scenes(max_nodes, count, seed=5, feat_dim=512):
    specs = [s for s in scenes.label_specs("val_scans", max_nodes)][:count]
    return scenes.make_scenes(specs, seed, num_points=POINTS, feat_dim=feat_dim)


def _batch(scs, bucket, feat_dim=512, dtype=torch.float64):
    b = collate([pad_scene(s["obj_points"], s["descriptor"], s["obj_2d_feats"], s["gt_class"],
                           s["edge_index"], s["gt_rels"], n_max=bucket, feat_dim=feat_dim)
                 for s in scs])
    return b.replace(**{k: v.to(dtype) for k, v in vars(b).items()
                        if v is not None and v.is_floating_point()})


def _recording(monkeypatch):
    seen = []
    real = dgcnn.knn_indices

    def knn(x, k):
        idx = real(x, k)
        seen.append((x, idx))
        return idx

    monkeypatch.setattr(dgcnn, "knn_indices", knn)
    return seen


@pytest.mark.parametrize("dim,heads,k", [(64, 4, 8), (512, 8, 20)])
def test_port_equals_the_plain_reference_in_float64(dim, heads, k, monkeypatch):
    model, ref, _ = _port_and_reference(dim, heads, k)
    scs = _scenes(9, 3, feat_dim=dim)
    seen = _recording(monkeypatch)
    with torch.no_grad():
        out = model(_batch(scs, 12, feat_dim=dim), branch_3d_only=True)
        blk = plain.flatten(scs, torch.device("cpu"))
        blk = {key: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
               for key, v in blk.items()}
        counts = [len(s["gt_class"]) for s in scs]
        sets = [torch.cat([idx[j, :n] for j, n in enumerate(counts)]) for _, idx in seen]
        want = ref.forward_3d(blk, sets)
    assert len(sets) == 4 and sets[0].shape[-1] == k
    for (x, idx), s in zip(seen, sets):  # every chosen set is a true kNN in float64
        xs = torch.cat([x[j, :n] for j, n in enumerate(counts)])
        near = R.knn64(xs.transpose(1, 2), k)
        assert torch.all(near["dist"].gather(-1, s).amax(-1) <= near["kth"])
    for j, ((a, b), (c, d)) in enumerate(zip(blk["nodes"], blk["edges"])):
        torch.testing.assert_close(out["obj_logits_3d"][j, :b - a], want["obj_logits_3d"][a:b],
                                   **GATE)
        torch.testing.assert_close(out["rel_cls_3d"][j, :d - c], want["rel_cls_3d"][c:d], **GATE)


def test_reference_own_knn_agrees_with_given_sets():
    """Without given sets the reference takes its own kNN, the source's
    form; in float64 on these clouds those are the float64 top k."""
    _, ref, _ = _port_and_reference(64, 4, 8)
    blk = plain.flatten(_scenes(9, 2, feat_dim=64), torch.device("cpu"))
    pts = blk["obj_points"].double()
    with torch.no_grad():
        rec = []
        ref.backbone_3d(pts, record=rec)
        again = ref.backbone_3d(pts, sets=[s for _, s in rec])
        torch.testing.assert_close(ref.backbone_3d(pts), again, rtol=0, atol=0)
    for x, s in rec:
        near = R.knn64(x, 8)
        assert torch.all(near["dist"].gather(-1, s).amax(-1) <= near["kth"])


def test_3d_only_outputs_equal_the_dual_forward_bit_for_bit():
    model, _, _ = _port_and_reference(512, 8, 20, dtype=torch.float32)
    b = _batch(_scenes(12, 3), 12, dtype=torch.float32)
    step3, dual = (make_eval_step(model, branch_3d_only=m, device="cpu") for m in (True, False))
    state = model.state_dict()
    got, want = step3(state, b), dual(state, b)
    assert set(got) == {"obj_logits_3d", "rel_cls_3d"}
    for key in got:
        assert torch.equal(got[key], want[key]), key


def test_import_round_trips_the_original_layout():
    model, ref, layout = _port_and_reference(512, 8, 20, dtype=torch.float32)
    sd = model.state_dict()
    bn = layout["backbone"]
    assert not np.allclose(bn["conv3.1.running_var"], 1.0)  # statistics that are not identity
    assert not np.allclose(bn["conv3.1.running_mean"], 0.0)
    for i in range(1, 6):
        w = bn[f"conv{i}.0.weight"]
        np.testing.assert_array_equal(sd[f"backbone.conv{i}_fc.weight"].numpy(),
                                      w.reshape(w.shape[0], -1))
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            np.testing.assert_array_equal(sd[f"backbone.conv{i}_bn.{leaf}"].numpy(),
                                          bn[f"conv{i}.1.{leaf}"])
    gcn = layout["edge_gcn"]
    for branch in ("3d", "2d"):
        p = f"edgegcn_{branch}"
        for i in (1, 2):
            np.testing.assert_array_equal(sd[f"edge_gcn.{p}.node_GConv{i}_fc.weight"].numpy(),
                                          gcn[f"{p}.node_GConv{i}.lin.weight"])
            np.testing.assert_array_equal(sd[f"edge_gcn.{p}.node_GConv{i}_fc.bias"].numpy(),
                                          gcn[f"{p}.node_GConv{i}.bias"])
            np.testing.assert_array_equal(sd[f"edge_gcn.{p}.edge_MLP{i}_fc.weight"].numpy(),
                                          gcn[f"{p}.edge_MLP{i}.0.weight"][..., 0])
        head = layout[f"rel_classifier_{branch}"]
        np.testing.assert_array_equal(sd[f"rel_classifier_{branch}.edge_bn.running_var"].numpy(),
                                      head["edge_BnReluDp.0.running_var"])
    np.testing.assert_array_equal(sd["edge_gcn.self_attn.fc_q.weight"].numpy(),
                                  gcn["self_attn.attention.fc_q.weight"])
    np.testing.assert_array_equal(sd["edge_gcn.self_attn_fc.ln1.weight"].numpy(),
                                  gcn["self_attn_fc.5.weight"])
    np.testing.assert_array_equal(sd["triplet_projector_3d.fc1.weight"].numpy(),
                                  layout["triplet_projector_3d"]["3.weight"])
    assert float(sd["obj_logit_scale"]) == pytest.approx(float(ref.obj_logit_scale.detach()))
    # every float leaf of the layout lands in one slot of the port
    n_layout = sum(v.size for d in layout.values() for key, v in d.items()
                   if not key.endswith("num_batches_tracked"))
    assert n_layout == sum(v.numel() for v in sd.values())


def test_batched_server_answers_sggpoint_requests():
    model, _, _ = _port_and_reference(512, 8, 20, dtype=torch.float32)
    scs = _scenes(9, 3)
    want = make_eval_step(model, branch_3d_only=True, device="cpu")(
        model.state_dict(), _batch(scs, 12, dtype=torch.float32))
    with BatchedServer(model, device="cpu", max_batch=4, deadline_ms=50.0,
                       pad_to_max=False) as server:
        futs = [server.submit({"obj_points": s["obj_points"], "descriptor": s["descriptor"]})
                for s in scs]
        got = [f.result(timeout=300) for f in futs]
    for j, (s, g) in enumerate(zip(scs, got)):
        n, e = len(s["gt_class"]), len(s["edge_index"])
        np.testing.assert_array_equal(g["edge_index"], s["edge_index"])
        np.testing.assert_allclose(g["obj_logits"], want["obj_logits_3d"][j, :n].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g["rel_cls"], want["rel_cls_3d"][j, :e].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert server.stats["scenes"] == 3 and server.stats["failed"] == 0


def test_dgcnn_span_and_instance_counters_under_a_profiler():
    model, _, _ = _port_and_reference(64, 4, 8, dtype=torch.float32)
    scs = _scenes(9, 3, feat_dim=64)
    profiling.clear()
    with BatchedServer(model, device="cpu", max_batch=4, deadline_ms=200.0, feat_dim=64,
                       pad_to_max=True) as server:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            futs = [server.submit({"obj_points": s["obj_points"],
                                   "descriptor": s["descriptor"]}) for s in scs]
            for f in futs:
                f.result(timeout=300)
    recorded = profiling.spans()
    dg = [s for s in recorded if s.name == "model.dgcnn"]
    steps = [s for s in recorded if s.name == "serve.step"]
    assert dg and steps
    valid = sum(len(s["gt_class"]) for s in scs)
    assert len(dg) == len(steps) == server.stats["batches"]
    assert all(s.attrs["points"] == POINTS and s.attrs["k"] == 8 for s in dg)
    assert all(s.attrs["fused"] == 4 for s in dg)  # the served step's stages, factored
    # B * N: max_batch scenes (pad_to_max) at the batch's bucket
    assert [s.attrs["slots"] for s in dg] == [s.attrs["instance_slots"] for s in steps]
    assert all(s.attrs["instance_slots"] % 4 == 0 for s in steps)
    assert sum(s.attrs["instances"] for s in steps) == valid == server.stats["instances"]
    assert sum(s.attrs["instance_slots"] for s in steps) == server.stats["instance_slots"]
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model.train()(_batch(scs, 12, feat_dim=64, dtype=torch.float32), istrain=True,
                      rng=torch.Generator().manual_seed(0))
    (train,) = [s for s in profiling.spans() if s.name == "model.dgcnn"]
    assert train.attrs["fused"] == 0  # training runs the dense stages
    profiling.clear()


def test_eval_step_reports_instances_of_a_host_batch():
    model, _, _ = _port_and_reference(64, 4, 8, dtype=torch.float32)
    b = _batch(_scenes(9, 2, feat_dim=64), 12, feat_dim=64, dtype=torch.float32)
    step = make_eval_step(model, branch_3d_only=True, device="cpu")
    take_instances()
    step(model.state_dict(), b)
    assert take_instances() == (int(b.obj_mask.sum()), b.obj_mask.numel())
    assert take_instances() is None


@pytest.mark.parametrize("name", ["MmgnetSingle", "SGFN", "MMteacher", "SGGpointBaseline"])
def test_models_without_a_3d_only_mode_still_raise(name):
    model, _ = build_model(name, 160, 26, _mcfg())
    assert not has_3d_only_mode(model)
    with pytest.raises(ValueError, match="serving mode"):
        make_eval_step(model, branch_3d_only=True, device="cpu")


@pytest.mark.parametrize("name", ["Mmgnet", "MmgnetIn21k", "MMteacher", "SGFN", "SGGpoint"])
def test_layer_norm_epsilon_of_each_build(name):
    """Registry builds: torch's 1e-5, the original's; the config dataclasses
    and a flax bridge: flax's 1e-6; the original's checkpoint import keeps
    the model's."""
    model, _ = build_model(name, 160, 26, _mcfg())
    norms = [m for m in model.modules() if isinstance(m, nn.LayerNorm)]
    assert norms and {m.eps for m in norms} == {TORCH_LN_EPS}
    assert type(model)(type(model.cfg)()).cfg.ln_eps == FLAX_LN_EPS
    params, stats = state_dict_to_flax(model.state_dict())
    torch_import.to_state_dict({"params": params, "batch_stats": stats}, model)
    assert {m.eps for m in norms} == {TORCH_LN_EPS}
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    assert {m.eps for m in norms} == {FLAX_LN_EPS}
