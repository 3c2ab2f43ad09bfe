"""The port's dual-branch MMGNet forward against the JAX package's, on bridged
weights (CPU, fp32).

Same recipe as tests/test_torch_port_model.py: ``flax MMGNet.init`` from a
seed -> ``interop.from_flax`` -> the port, both on the same ``make_batch``
scenes, with the gate of tests/test_parity_torch.py (rtol 1e-3, atol 1e-4)
on live rows of all four outputs.  The port's 3D outputs of the full forward
must equal those of its dense 3D-only forward bit for bit, and those of the
3D-only eval step (the server's, which packs a host batch's edge rows)
within one ulp on live rows (a GEMM over another number of rows may round
the last bit otherwise) and at fp32 tolerance on padded ones.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import NARROW, flax_variables, port_config, to_torch
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict
from vlsat_tpu_torch.models.mmgnet import MMGNet
from vlsat_tpu_torch.train.step import make_eval_step, take_edge_rows

RTOL, ATOL = 1e-3, 1e-4
KEYS = ("obj_logits_3d", "obj_logits_2d", "rel_cls_3d", "rel_cls_2d")

# (widths, bucket, node counts, points per instance); B > 1 everywhere
CASES = {
    "bucket8": (dict(NARROW), 8, (5, 8, 3), 16),
    "bucket12": (dict(NARROW), 12, (9, 12), 16),
    "bucket16": (dict(NARROW), 16, (13, 16, 6), 8),
    "full_width": ({}, 8, (6, 8), 32),
    # the config keys the registry wires (MODEL.GCN_AGGR, USE_GCN_EDGE,
    # multi_rel_outputs)
    "gcn_aggr_add": (dict(NARROW, gcn_aggr="add"), 8, (5, 8, 3), 16),
    "gcn_aggr_mean": (dict(NARROW, gcn_aggr="mean"), 8, (5, 8, 3), 16),
    "no_gcn_edge": (dict(NARROW, use_gcn_edge=False), 8, (5, 8, 3), 16),
    "single_label": (dict(NARROW, multi_rel_outputs=False), 8, (5, 8, 3), 16),
}


def _run(case: str, fused: bool):
    widths, bucket, nodes, points = CASES[case]
    jcfg = FlaxConfig(**widths, fused_pointnet=fused)
    batch = make_batch(seed=3, node_counts=nodes, num_points=points, bucket=bucket,
                       feat_dim=jcfg.clip_feat_dim, num_obj_classes=jcfg.num_obj_classes,
                       num_rel_classes=jcfg.num_rel_classes)
    params, stats = flax_variables(tuple(widths.items()), seed=5)
    want = jax.jit(lambda p, s, b: FlaxMMGNet(cfg=jcfg).apply(
        {"params": p, "batch_stats": s}, b, istrain=False))(params, stats, batch)
    cfg = port_config(jcfg)
    model = MMGNet(cfg)
    state = flax_to_state_dict(params, stats, model)
    tb = to_torch(batch)
    got = make_eval_step(model, device="cpu")(state, tb)
    got_3d = make_eval_step(model, branch_3d_only=True, device="cpu")(state, tb)
    assert take_edge_rows()[0] < tb.edge_mask.numel()  # it packed
    with torch.inference_mode():
        dense_3d = torch.func.functional_call(model, state, (tb,), {"branch_3d_only": True})
    return batch, want, got, (got_3d, dense_3d)


def _assert_live_rows_match(got, want, batch):
    masks = {"obj": np.asarray(batch.obj_mask), "rel": np.asarray(batch.edge_mask)}
    assert sorted(got) == sorted(KEYS)
    for key in KEYS:
        mask = masks[key.split("_")[0]]
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        assert np.isfinite(g[mask]).all(), key
        np.testing.assert_allclose(g[mask], w[mask], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("case,fused", [
    ("bucket8", False), ("bucket8", True), ("bucket12", False), ("bucket12", True),
    ("bucket16", False), ("full_width", True), ("gcn_aggr_add", False),
    ("gcn_aggr_mean", False), ("no_gcn_edge", False), ("single_label", False)])
def test_dual_forward_matches_jax(case, fused):
    batch, want, got, (got_3d, dense_3d) = _run(case, fused)
    _assert_live_rows_match(got, want, batch)
    assert sorted(got_3d) == sorted(dense_3d) == ["obj_logits_3d", "rel_cls_3d"]
    masks = {"obj": torch.from_numpy(np.array(batch.obj_mask)),
             "rel": torch.from_numpy(np.array(batch.edge_mask))}
    for key in got_3d:
        assert torch.equal(got[key], dense_3d[key]), key
        live = masks[key.split("_")[0]]
        torch.testing.assert_close(got_3d[key][live], got[key][live],
                                   rtol=torch.finfo(torch.float32).eps, atol=0, msg=key)
        torch.testing.assert_close(got_3d[key], got[key], equal_nan=True, msg=key)


def test_dual_forward_on_the_library_attention_route(monkeypatch):
    """Every attention (node self/cross and the edge-level cross-attention)
    on the large-score route in both packages: the gate at 1 element."""
    from vlsat_tpu.ops import attention as JA
    from vlsat_tpu_torch.ops import attention as TA

    monkeypatch.setattr(JA, "LARGE_SCORE_ELEMENTS", 1)
    monkeypatch.setattr(TA, "LARGE_SCORE_ELEMENTS", 1)
    batch, want, got, _ = _run("bucket8", False)
    _assert_live_rows_match(got, want, batch)
