"""SGPN served 3D only, on the CPU: the port (the registry's model loaded
through ``interop.torch_import.import_sgpn``) against the benchmark's plain
reference ``benchmark/reference/sgpn.py`` on its seeded weights in the
original checkpoint layout, through ``BatchedServer`` with each request's
union clouds (``benchmark/harness/union.py``, 32 points an edge here); the
packed forward against the dense one; the import's layout; requests
without their clouds; the servers of other models, which ship none; the
``fused_pointnet`` key; the ``model.union`` span and the server's union
counters.

Gates: the served answers at the parity gate of tests/test_parity_torch.py
(fp32, rtol 1e-3, atol 1e-4); packed against dense at 1e-5 (the same
products over fewer rows, in another blocking).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import scenes, union
from benchmark.harness.weights import build_reference
from benchmark.reference import plain
from benchmark.reference import sgpn as R
from tests.torch_threads import one_thread  # noqa: F401
from vlsat_tpu_torch.config import load_config
from vlsat_tpu_torch.interop import torch_import
from vlsat_tpu_torch.models.registry import build_model
from vlsat_tpu_torch.scene import collate, edge_count, pad_scene, pick_bucket
from vlsat_tpu_torch.serving import BatchedServer
from vlsat_tpu_torch.train.step import has_3d_only_mode, make_eval_step, take_edge_rows
from vlsat_tpu_torch.utils import profiling

GATE = dict(rtol=1e-3, atol=1e-4)
POINTS, UNION = 32, 32
SEED = 2400000017


def _port_and_reference(seed=SEED, fused=True):
    ref = build_reference(R.SGPNReference, torch.device("cpu"), seed, num_obj=160, num_rel=26)
    layout = R.module_state_dicts(ref)
    mcfg = load_config(overrides={"MODEL": {"fused_pointnet": fused}}).MODEL
    model, _ = build_model("SGPN", 160, 26, mcfg)
    model.load_state_dict(torch_import.to_state_dict(torch_import.import_sgpn(layout), model))
    return model.eval(), ref, layout


def _scenes(count=4, max_nodes=9, seed=5):
    specs = [s for s in scenes.label_specs("val_splits") if len(s["gt_class"]) <= max_nodes]
    specs = sorted(specs, key=lambda s: len(s["gt_class"]))[::40][:count]
    pool = scenes.make_scenes(specs, seed, num_points=POINTS, with_2d=False)
    for s, clouds in zip(pool, union.make_unions(pool, seed, points=UNION)):
        s["rel_points"] = clouds
    return pool


def _request(s, **drop):
    return {k: s[k] for k in ("obj_points", "descriptor", "rel_points") if k not in drop}


def _dense_batch(pool, bucket):
    return collate([pad_scene(s["obj_points"], s["descriptor"], s["obj_2d_feats"],
                              s["gt_class"], s["edge_index"], s["gt_rels"], n_max=bucket,
                              rel_points=s["rel_points"].astype(np.float32)) for s in pool])


def test_served_sgpn_equals_the_plain_reference():
    model, ref, _ = _port_and_reference()
    pool = _scenes()
    assert [len(s["gt_class"]) for s in pool] == sorted(len(s["gt_class"]) for s in pool)
    assert 4 <= len(pool[0]["gt_class"]) and len(pool[-1]["gt_class"]) <= 9
    with BatchedServer(model, device="cpu", max_batch=4, deadline_ms=200.0) as server:
        answers = [f.result(timeout=120) for f in [server.submit(_request(s)) for s in pool]]
    assert server.stats["batches"] == 1 and server.stats["union_rows"] > 0
    with torch.no_grad():
        blk = plain.flatten(pool, torch.device("cpu"))
        want = ref.forward_3d(blk, torch.from_numpy(np.concatenate(
            [s["rel_points"] for s in pool])), rows=7)
    for a, ((n0, n1), (e0, e1)) in zip(answers, zip(blk["nodes"], blk["edges"])):
        torch.testing.assert_close(torch.from_numpy(a["obj_logits"]),
                                   want["obj_logits_3d"][n0:n1], **GATE)
        torch.testing.assert_close(torch.from_numpy(a["rel_cls"]),
                                   want["rel_cls_3d"][e0:e1], **GATE)


def test_packed_forward_equals_the_dense_forward():
    """The 3D-only step over a host batch packs its edge rows (the valid
    ones and one a scene with padding) and the dense union clouds' rows with
    them; the same batch already 'on the device' runs dense."""
    model, _, _ = _port_and_reference(fused=False)
    pool = _scenes()
    batch = _dense_batch(pool, 12)
    step = make_eval_step(model, branch_3d_only=True, device="cpu")
    packed = step(model.state_dict(), batch)
    rows, slots = take_edge_rows()
    assert rows == int(batch.edge_mask.sum()) + len(pool) < slots
    with torch.no_grad():
        dense = model(batch, branch_3d_only=True)
    for key in ("obj_logits_3d", "rel_cls_3d"):
        torch.testing.assert_close(packed[key], dense[key], rtol=1e-5, atol=1e-5, msg=key)


def test_import_sgpn_round_trips_the_original_layout():
    model, ref, layout = _port_and_reference()
    assert set(layout) == {"obj_encoder", "rel_encoder", "obj_predictor", "rel_predictor"}
    assert layout["rel_encoder"]["conv1.weight"].shape == (64, 4, 1)  # Conv1d (out, in, 1)
    sd = model.state_dict()
    for child, entries in layout.items():
        for key, value in entries.items():
            got = sd[f"{child}.{key}"].numpy()
            np.testing.assert_array_equal(got, value.reshape(got.shape), err_msg=key)
    assert len(sd) == sum(len(v) for v in layout.values())


def test_a_request_without_union_clouds_fails_alone():
    model, _, _ = _port_and_reference()
    pool = _scenes(3)
    bad_rows = dict(_request(pool[1]), rel_points=pool[1]["rel_points"][:-1])
    with BatchedServer(model, device="cpu", max_batch=4, deadline_ms=200.0) as server:
        futs = [server.submit(_request(pool[0])), server.submit(_request(pool[1], rel_points=1)),
                server.submit(bad_rows), server.submit(_request(pool[2]))]
        with pytest.raises(ValueError, match="needs rel_points"):
            futs[1].result(timeout=1)
        with pytest.raises(ValueError, match="a row for each"):
            futs[2].result(timeout=1)
        good = [futs[0].result(timeout=120), futs[3].result(timeout=120)]
    assert server.stats["batches"] == 1 and server.stats["scenes"] == 2
    assert server.stats["failed"] == 0
    for a, s in zip(good, (pool[0], pool[2])):
        assert a["rel_cls"].shape == (len(s["edge_index"]), 26)


def test_other_servers_allocate_no_union_block():
    """A model that reads no union clouds: its step says so, its server
    ignores ``rel_points`` a request carries, writes no union block and
    counts none."""
    mcfg = load_config(overrides={"MODEL": {"N_LAYERS": 1}}).MODEL
    model, _ = build_model("Mmgnet", 160, 26, mcfg)
    assert not make_eval_step(model, branch_3d_only=True, device="cpu").union_rows
    pool = _scenes(3)
    with BatchedServer(model, device="cpu", max_batch=4, deadline_ms=200.0) as server:
        futs = [server.submit(_request(pool[0])),
                server.submit(_request(pool[1], rel_points=1))]
        for f in futs:
            f.result(timeout=120)
    assert server.stats["union_rows"] == server.stats["union_bytes"] == 0
    assert all(ws.union is None for ws in server._wire.values())


@pytest.mark.parametrize("name", ["Mmgnet", "MmgnetSingle", "MMteacher", "MmgnetIn21k", "SGFN",
                                  "SGPN", "SGGpoint", "SGGpointBaseline"])
def test_fused_pointnet_key(name):
    """Off unless a config sets it: every entry builds the model it built
    before; on, MMGNet's object encoder and SGPN's two encoders take the
    kernel route."""
    def encoders(fused):
        mcfg = load_config(overrides={"MODEL": {"fused_pointnet": fused}} if fused
                           else None).MODEL
        model, _ = build_model(name, 160, 26, mcfg)
        return {k: m.fused for k, m in model.named_modules() if hasattr(m, "fused")}

    assert not any(encoders(False).values())
    on = {k for k, v in encoders(True).items() if v}
    assert on == {"Mmgnet": {"obj_encoder"}, "MmgnetIn21k": {"obj_encoder"},
                  "SGPN": {"obj_encoder", "rel_encoder"}}.get(name, set())


def test_union_span_and_server_counters():
    model, _, _ = _port_and_reference()
    assert has_3d_only_mode(model) and model.needs_rel_points
    pool = _scenes(3)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with BatchedServer(model, device="cpu", max_batch=4, deadline_ms=200.0) as server:
            for f in [server.submit(_request(s)) for s in pool]:
                f.result(timeout=120)
    spans = profiling.spans()
    unions = [s for s in spans if s.name == "model.union"]
    prepares = [s for s in spans if s.name == "serve.prepare"]
    e_max = edge_count(pick_bucket(max(len(s["gt_class"]) for s in pool)))
    edges = [len(s["edge_index"]) for s in pool] + [0]  # the fourth slot: the pad scene
    rows = sum(edges) + sum(e < e_max for e in edges)  # and one padding row a slot
    assert [s.attrs for s in unions] == [{"rows": rows, "points": UNION, "fused": True}]
    assert [(s.attrs["union_rows"], s.attrs["union_bytes"]) for s in prepares] == \
        [(rows, rows * UNION * 4 * 2)]  # the f16 wire
    assert (server.stats["union_rows"], server.stats["union_bytes"]) == (rows, rows * UNION * 8)
