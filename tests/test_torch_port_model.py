"""The port's 3D-only MMGNet forward against the JAX package's, on bridged
weights (CPU, fp32).

``flax MMGNet.init`` from a seed -> ``interop.from_flax`` -> the port; both
run the same ``make_batch`` scenes.  Gate: rtol 1e-3, atol 1e-4, the gate of
tests/test_parity_torch.py (fp32 sums are taken in another order by XLA and
by torch across ~30 chained matmuls).  Only live rows are compared.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.train.step import make_eval_step

RTOL, ATOL = 1e-3, 1e-4

NARROW = dict(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
              dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64)


def port_config(jcfg: FlaxConfig) -> MMGNetConfig:
    return MMGNetConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(MMGNetConfig)
                           if hasattr(jcfg, f.name)})


def to_torch(batch) -> SceneBatch:
    kw = {f.name: getattr(batch, f.name) for f in dataclasses.fields(SceneBatch)}
    return SceneBatch(**{k: None if v is None else torch.from_numpy(np.array(v))
                         for k, v in kw.items()})


@functools.lru_cache(maxsize=None)
def flax_variables(widths: tuple, seed: int):
    """Init the flax model (all branches, as training does), then give BN
    non-trivial running stats so the eval-mode BN path is exercised.  The
    parameters do not depend on the bucket or on ``fused_pointnet``, so each
    width is initialised once per module."""
    jcfg = FlaxConfig(**dict(widths))
    batch = make_batch(seed=0, node_counts=(3,), num_points=8, bucket=4,
                       feat_dim=jcfg.clip_feat_dim, num_obj_classes=jcfg.num_obj_classes,
                       num_rel_classes=jcfg.num_rel_classes)
    v = FlaxMMGNet(cfg=jcfg).init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        batch, istrain=True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    rng = np.random.RandomState(seed + 2)
    bn = stats["mlp_3d_bn"]
    bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.5).astype(np.float32)
    bn["var"] = (rng.rand(*bn["var"].shape) + 0.5).astype(np.float32)
    return params, stats


def assert_live_rows_match(got, want, batch):
    obj_mask = np.asarray(batch.obj_mask)
    edge_mask = np.asarray(batch.edge_mask)
    for key, mask in (("obj_logits_3d", obj_mask), ("rel_cls_3d", edge_mask)):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        assert np.isfinite(g[mask]).all(), key
        np.testing.assert_allclose(g[mask], w[mask], rtol=RTOL, atol=ATOL, err_msg=key)


CASES = {
    "bucket8": (dict(NARROW), 8, (5, 8), 16),
    "bucket12": (dict(NARROW), 12, (9, 12), 16),
    "full_width": ({}, 8, (6, 8), 32),
}


@pytest.mark.parametrize("case,fused", [
    ("bucket8", False), ("bucket8", True), ("bucket12", False), ("bucket12", True),
    ("full_width", True)])
def test_3d_forward_matches_jax(case, fused):
    widths, bucket, nodes, points = CASES[case]
    jcfg = FlaxConfig(**widths, fused_pointnet=fused)
    batch = make_batch(seed=3, node_counts=nodes, num_points=points, bucket=bucket,
                       feat_dim=jcfg.clip_feat_dim, num_obj_classes=jcfg.num_obj_classes,
                       num_rel_classes=jcfg.num_rel_classes)
    params, stats = flax_variables(tuple(widths.items()), seed=5)
    want = jax.jit(lambda p, s, b: FlaxMMGNet(cfg=jcfg).apply(
        {"params": p, "batch_stats": s}, b, istrain=False, branch_3d_only=True))(
        params, stats, batch)

    cfg = port_config(jcfg)
    model = MMGNet(cfg)
    state = flax_to_state_dict(params, stats, model)
    step = make_eval_step(model, branch_3d_only=True, device="cpu")
    got = step(state, to_torch(batch))
    assert_live_rows_match(got, want, batch)


def test_bridge_round_trip_is_bit_equal():
    jcfg = FlaxConfig(**NARROW)
    params, stats = flax_variables(tuple(NARROW.items()), seed=5)
    state = flax_to_state_dict(params, stats, MMGNet(port_config(jcfg)))
    back_p, back_s = state_dict_to_flax(state)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}"
            if isinstance(v, dict):
                yield from leaves(v, p)
            else:
                yield p, v

    # every leaf, the 2D subtrees and the train-time triplet projector included
    want_p = dict(leaves(params))
    assert any(k.startswith("/mmg/cross_attn_rel_") for k in want_p)
    assert any(k.startswith("/triplet_projector_2d/") for k in want_p)
    got_p = dict(leaves(back_p))
    assert sorted(got_p) == sorted(want_p)
    for k, v in want_p.items():
        assert got_p[k].dtype == v.dtype and got_p[k].shape == v.shape, k
        np.testing.assert_array_equal(got_p[k], v, err_msg=k)
    got_s, want_s = dict(leaves(back_s)), dict(leaves(stats))
    assert sorted(got_s) == sorted(want_s)
    for k, v in want_s.items():
        np.testing.assert_array_equal(got_s[k], v, err_msg=k)


def test_bridge_rejects_unknown_and_missing_leaves():
    jcfg = FlaxConfig(**NARROW)
    params, stats = flax_variables(tuple(NARROW.items()), seed=5)
    model = MMGNet(port_config(jcfg))
    extra = dict(params, stray_head={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray_head"):
        flax_to_state_dict(extra, stats, model)
    missing = {k: v for k, v in params.items() if k != "obj_predictor_3d"}
    with pytest.raises(KeyError, match="obj_predictor_3d"):
        flax_to_state_dict(missing, stats, model)


def test_entry_points_refuse_cuda_without_a_card():
    from vlsat_tpu_torch.models.mmgnet import build_mmgnet

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mmgnet(port_config(FlaxConfig(**NARROW)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(MMGNet(port_config(FlaxConfig(**NARROW))))


def _served_batch(cfg, bucket, counts, pad_to, subset=False, seed=0):
    """A host batch as the server builds it: scenes of ``counts`` nodes padded
    to ``bucket``, then all-zero scenes up to ``pad_to`` (``pad_to_max``).
    ``subset``: each scene keeps a random half of its directed edges, and its
    edge rows are shuffled, so valid rows are not a prefix and some invalid
    rows keep real endpoints (masked out, not (0, 0))."""
    from vlsat_tpu_torch.data.synthetic import make_scene
    from vlsat_tpu_torch.scene import collate, pad_scene

    rng = np.random.RandomState(seed)
    padded = []
    for n in counts:
        s = make_scene(rng, n, num_points=8, feat_dim=cfg.clip_feat_dim,
                       num_obj_classes=cfg.num_obj_classes, num_rel_classes=cfg.num_rel_classes)
        ei, rels = s["edge_index"], s["gt_rels"]
        if subset:
            keep = np.sort(rng.permutation(len(ei))[:max(len(ei) // 2, 1)])
            ei, rels = ei[keep], rels[keep]
        p = pad_scene(s["obj_points"], s["descriptor"], s["obj_2d_feats"], s["gt_class"], ei,
                      rels, n_max=bucket, feat_dim=cfg.clip_feat_dim)
        if subset:
            order = rng.permutation(len(p["edge_mask"]))
            for k in ("edge_index", "edge_mask", "gt_rels"):
                p[k] = p[k][order]
            real = np.flatnonzero(p["edge_mask"])[::3]
            p["edge_mask"][real] = False  # masked edges with their endpoints
        padded.append(p)
    while len(padded) < pad_to:
        padded.append({k: np.zeros_like(v) for k, v in padded[0].items()})
    return collate(padded)


@pytest.mark.parametrize("bucket,counts,pad_to,subset", [
    (8, (5, 8, 3), 3, False),        # a full scene, no zero scene
    (8, (8, 8), 4, False),           # no padded edge row in the real scenes
    (12, (9, 12, 4), 6, False),
    (12, (11, 6, 9), 5, True),       # valid rows not a prefix, masked real edges
    (64, (40, 7, 64, 23), 6, False),
    (64, (50, 33), 3, True),
])
def test_packed_3d_forward_equals_dense(bucket, counts, pad_to, subset):
    """The 3D-only eval step on a host batch runs its per-edge layers on the
    packed edge rows (``ops.graph.EdgeRows``); both outputs equal the dense
    forward's in every row, padded rows and all-zero scenes included (their
    NaNs where the dense forward has them), at fp32 tolerance."""
    _assert_packed_equals_dense(MMGNetConfig(**NARROW), bucket, counts, pad_to, subset)


@pytest.mark.parametrize("widths,bucket,counts,pad_to,subset", [
    (dict(NARROW, gcn_aggr="add"), 12, (11, 6, 9), 5, True),
    (dict(NARROW, gcn_aggr="mean"), 12, (11, 6, 9), 5, True),
    (dict(NARROW, use_gcn_edge=False), 8, (5, 8, 3), 4, False),
    (dict(NARROW, multi_rel_outputs=False), 8, (5, 8, 3), 4, True),
    ({}, 8, (6, 8, 3), 4, False),
], ids=["gcn_aggr_add", "gcn_aggr_mean", "no_gcn_edge", "single_label", "full_width"])
def test_packed_3d_forward_equals_dense_per_config(widths, bucket, counts, pad_to, subset):
    """As above for the config keys the registry wires (MODEL.GCN_AGGR,
    USE_GCN_EDGE, multi_rel_outputs) and at the full widths."""
    _assert_packed_equals_dense(MMGNetConfig(**widths), bucket, counts, pad_to, subset)


def _assert_packed_equals_dense(cfg, bucket, counts, pad_to, subset):
    from vlsat_tpu_torch.models.mmgnet import build_mmgnet
    from vlsat_tpu_torch.train.step import take_edge_rows

    model = build_mmgnet(cfg, device="cpu", seed=4)
    for name, buf in model.named_buffers():  # non-trivial eval-mode BN statistics
        buf.copy_(torch.rand(buf.shape) + (0.5 if name.endswith("running_var") else -0.5))
    state = model.state_dict()
    batch = _served_batch(cfg, bucket, counts, pad_to, subset)
    with torch.inference_mode():
        dense = torch.func.functional_call(model, state, (batch,), {"branch_3d_only": True})
    take_edge_rows()
    packed = make_eval_step(model, branch_3d_only=True, device="cpu")(state, batch)
    rows, slots = take_edge_rows()
    assert slots == batch.edge_mask.numel() and rows < slots
    assert set(packed) == set(dense)
    for key in dense:
        assert packed[key].shape == dense[key].shape, key
        torch.testing.assert_close(packed[key], dense[key], equal_nan=True, msg=key)
    live = batch.edge_mask.numpy()
    assert np.isfinite(packed["rel_cls_3d"].numpy()[live]).all()
