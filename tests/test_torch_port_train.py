"""The port's training slice against the JAX package's, on the CPU.

Losses, the batch-statistics BatchNorm, the train-time outputs and their
gradients, the AdamW groups and schedule, a 3-step trajectory, the bridge of
a mid-run JAX state, dropout seeding, multi-step and text-table steps and
checkpoints.  Inputs come from numpy seeds; widths are the ``NARROW``
config of tests/test_torch_port_model.py.  Tolerances, per test:

  * losses: rtol 1e-5 / atol 1e-6 (the same fp32 formulas);
  * BatchNorm: rtol 1e-5 / atol 1e-6 on outputs and running statistics;
  * model outputs: the parity gate, rtol 1e-3 / atol 1e-4 on live rows;
  * gradients: per leaf, the gate of tests/test_parity_torch.py:568-575
    (``isclose(rtol=2e-3, atol=2e-3 * max|g|)``), on every element, with
    max|g| floored at 1e-6 of the largest gradient of any leaf;
  * schedules: rtol 1e-6 on the rates, 1e-4 on the applied updates (optax
    takes Adam's bias correction 1 - b2^t in fp32: ~3e-5 relative at t = 2);
  * trajectories: per-step losses rtol 1e-4; after 3 AdamW steps parameters
    atol 3 x lr (Adam turns fp32 noise on near-zero gradients into lr-sized
    steps, tests/test_train_step.py:93-96) and BatchNorm statistics atol
    1e-3; after 3 plain-SGD steps parameters rtol 1e-3 / atol 5e-5 and
    statistics rtol 1e-4 / atol 1e-6.
"""

from __future__ import annotations

import dataclasses
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_model import NARROW, flax_variables, port_config, to_torch
from tests.torch_threads import one_thread  # noqa: F401
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu.models.layers import MaskedBatchNorm as FlaxBN
from vlsat_tpu.train import losses as JL
from vlsat_tpu.train import optim as JO
from vlsat_tpu.train.state import TrainState as JaxState
from vlsat_tpu.train.step import make_train_step as jax_train_step
from vlsat_tpu_torch.interop.from_flax import (flax_to_state_dict, state_dict_to_flax,
                                               train_state_from_flax)
from vlsat_tpu_torch.models.layers import Dropout, MaskedBatchNorm
from vlsat_tpu_torch.models.mmgnet import MMGNet, build_mmgnet
from vlsat_tpu_torch.train import losses as TL
from vlsat_tpu_torch.train.checkpoint import CheckpointManager
from vlsat_tpu_torch.train.optim import label_params, make_optimizer
from vlsat_tpu_torch.train.state import create_train_state
from vlsat_tpu_torch.train.step import (fold_in, make_eval_step, make_multi_train_step,
                                        make_train_step, stack_batches)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
RTOL, ATOL = 1e-3, 1e-4
JCFG = FlaxConfig(**NARROW)
CFG = port_config(JCFG)
TEXT_DIM = 512  # the triplet projector's output width, whatever the model width


def train_batch(seed: int, nodes=(5, 8, 3), bucket: int = 8, points: int = 16):
    """A JAX batch at NARROW widths with unit-norm 512-d text targets."""
    b = make_batch(seed=seed, node_counts=nodes, num_points=points, bucket=bucket,
                   feat_dim=JCFG.clip_feat_dim, num_obj_classes=JCFG.num_obj_classes,
                   num_rel_classes=JCFG.num_rel_classes)
    rng = np.random.RandomState(seed + 100)
    t = rng.randn(b.num_scenes, b.num_edges, TEXT_DIM).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    t *= np.asarray(b.edge_mask)[..., None]
    return b.replace(rel_text_feat=jnp.asarray(t))


def port_model(seed: int = 5) -> MMGNet:
    params, stats = flax_variables(tuple(NARROW.items()), seed=seed)
    model = MMGNet(CFG)
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return model


def no_dropout(model: MMGNet) -> MMGNet:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@pytest.fixture
def flax_no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def flax_paths(model: MMGNet) -> dict:
    """Port parameter name -> the path of its flax leaf."""
    out = {}
    for n, p in model.named_parameters():
        ((path, _),) = leaves(state_dict_to_flax({n: p.detach()})[0])
        out[n] = path
    return out


def leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, p)
        else:
            yield p, np.asarray(v)


def assert_grad_gate(got: dict, want: dict):
    """The per-leaf gate; a leaf's scale is floored at 1e-6 of the largest
    gradient, since some gradients are zero up to fp32 noise (a key bias
    shifts each softmax row by a constant)."""
    assert sorted(got) == sorted(want)
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k]
        scale = max(np.abs(w).max(), floor)
        ok = np.isclose(g, w, rtol=2e-3, atol=2e-3 * scale)
        assert ok.all(), (k, float(ok.mean()), float(np.abs(g - w).max()))


# ------------------------------------------------------------------ losses

def _loss_inputs(seed: int, single_label: bool = False):
    """Model-shaped outputs and a batch, from one numpy seed; a few
    probabilities sit at exactly 0 and 1 (the BCE clip)."""
    jb = train_batch(seed)
    rng = np.random.RandomState(seed)
    b, n, e = jb.num_scenes, jb.num_nodes, jb.num_edges
    r = JCFG.num_rel_classes
    if single_label:
        labels = rng.randint(0, r, (b, e))
        jb = jb.replace(gt_rels=jnp.asarray(np.eye(r, dtype=np.float32)[labels]))
    out = {"obj_logits_3d": rng.randn(b, n, 20) * 3, "obj_logits_2d": rng.randn(b, n, 20) * 3,
           "obj_feature_3d_mimic": rng.randn(b, n, 64), "obj_features_2d_mimic": rng.randn(b, n, 64),
           "edge_feature_2d_dis": rng.randn(b, e, TEXT_DIM),
           "edge_feature_3d_dis": rng.randn(b, e, TEXT_DIM)}
    for k in ("rel_cls_3d", "rel_cls_2d"):
        x = rng.randn(b, e, r) * 2
        if single_label:
            out[k] = x - np.log(np.exp(x).sum(-1, keepdims=True))
        else:
            p = 1 / (1 + np.exp(-x))
            p.flat[:3] = (0.0, 1.0, 1e-9)
            out[k] = p
    out = {k: v.astype(np.float32) for k, v in out.items()}
    return out, jb


LOSS_CASES = {
    "total_dynamic": (lambda L, o, b, extra: L.vlsat_total_loss(o, b), False),
    "total_dynamic_ignore_none": (lambda L, o, b, extra: L.vlsat_total_loss(
        o, b, ignore_none_rel=True, none_ratio=0.5), False),
    "total_bg": (lambda L, o, b, extra: L.vlsat_total_loss(o, b, weight_mode="BG", w_bg=0.3),
                 False),
    "total_bg_zero": (lambda L, o, b, extra: L.vlsat_total_loss(o, b, weight_mode="BG",
                                                                w_bg=0.0), False),
    "total_occu": (lambda L, o, b, extra: L.vlsat_total_loss(
        o, b, weight_mode="OCCU", weights_rel=extra), False),
    "total_none": (lambda L, o, b, extra: L.vlsat_total_loss(o, b, weight_mode="NONE"), False),
    "total_lambda_o_2": (lambda L, o, b, extra: L.vlsat_total_loss(o, b, lambda_o=2.0), False),
    "total_without_mimic": (lambda L, o, b, extra: L.vlsat_total_loss(o, b, with_mimic=False),
                            False),
    "total_without_text": (lambda L, o, b, extra: L.vlsat_total_loss(
        o, b.replace(rel_text_feat=None)), False),
    "total_single_label": (lambda L, o, b, extra: L.vlsat_total_loss(o, b, multi_rel=False),
                           True),
    "total_single_label_ignore_none": (lambda L, o, b, extra: L.vlsat_total_loss(
        o, b, multi_rel=False, ignore_none_rel=True), True),
    "single_3d": (lambda L, o, b, extra: L.vlsat_single_loss(o, b), False),
    "single_3d_single_label": (lambda L, o, b, extra: L.vlsat_single_loss(
        o, b, multi_rel=False), True),
    "sgfn": (lambda L, o, b, extra: L.sgfn_loss(o, b), False),
    "sgfn_bg": (lambda L, o, b, extra: L.sgfn_loss(o, b, weight_mode="BG", w_bg=0.7), False),
    "sgpn": (lambda L, o, b, extra: L.sgpn_loss(o, b), False),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_objective_matches_jax(case):
    fn, single = LOSS_CASES[case]
    out, jb = _loss_inputs(11, single_label=single)
    occu = np.random.RandomState(3).rand(JCFG.num_rel_classes).astype(np.float32)
    want, want_aux = fn(JL, {k: jnp.asarray(v) for k, v in out.items()}, jb, jnp.asarray(occu))
    got, got_aux = fn(TL, {k: torch.from_numpy(v) for k, v in out.items()}, to_torch(jb),
                      torch.from_numpy(occu))
    assert sorted(got_aux) == sorted(want_aux)
    for k, w in want_aux.items():
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(w), **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def _mask_cases():
    """(x, mask) pairs: the JAX tests' masked-mean case, random ones, and an
    all-padded mask (denominator clamped at 1)."""
    rng = np.random.RandomState(0)
    return {
        "jax_case": (np.array([[1.0, 2.0], [100.0, 200.0]], np.float32), np.array([True, False])),
        "broadcast": (rng.randn(3, 8, 5).astype(np.float32), rng.rand(3, 8) > 0.3),
        "all_padded": (rng.randn(2, 4).astype(np.float32), np.zeros((2, 4), bool)),
    }


def _part_cases():
    rng = np.random.RandomState(1)
    gt = np.zeros((1, 5, 3), np.float32)  # tests/test_losses.py: counts [2, 1, 0]
    gt[0, 0, 0] = gt[0, 1, 0] = gt[0, 1, 1] = gt[0, 4, 2] = 1
    gt_mask = np.array([[True, True, True, True, False]])
    onehot = np.zeros((1, 4, 3), np.float32)  # tests/test_single_label.py
    onehot[0, 0, 0] = onehot[0, 1, 1] = onehot[0, 2, 2] = onehot[0, 3, 1] = 1
    oh_mask = np.array([[True, True, True, False]])
    p = rng.rand(1, 6, 4).astype(np.float32) * 0.9 + 0.05
    t = (rng.rand(1, 6, 4) < 0.4).astype(np.float32)
    w = rng.rand(4).astype(np.float32)
    m6 = np.array([[True] * 4 + [False] * 2])
    logp = np.log(np.array([[[0.5, 0.3, 0.2], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.3, 0.4]]],
                           np.float32))
    ei = np.array([[[0, 1], [1, 2], [2, 0], [0, 0]]], np.int32)
    cases = {
        "dynamic_weights": ("dynamic_rel_weights", (gt, gt_mask), {}),
        "dynamic_weights_ignore_none": ("dynamic_rel_weights", (gt, gt_mask),
                                        {"ignore_none_rel": True}),
        "dynamic_weights_none_ratio": ("dynamic_rel_weights", (gt, gt_mask), {"none_ratio": 0.3}),
        "bce_weighted": ("weighted_bce", (p, t, w, m6), {}),
        "bce_unweighted": ("weighted_bce", (p, t, None, m6), {}),
        "bce_clipped": ("weighted_bce", (np.array([[[0.0, 1.0, 1e-9]]], np.float32),
                                         np.array([[[1.0, 0.0, 1.0]]], np.float32), None,
                                         np.array([[True]])), {}),
        "single_label_weights": ("single_label_rel_weights", (onehot, oh_mask), {}),
        "single_label_weights_ignore_none": ("single_label_rel_weights", (onehot, oh_mask),
                                             {"ignore_none_rel": True}),
        "single_label_nll": ("single_label_rel_nll", (logp, onehot, w[:3], oh_mask), {}),
        "single_label_nll_unweighted": ("single_label_rel_nll", (logp, onehot, None, oh_mask),
                                        {}),
        "cosine_mimic": ("cosine_mimic_loss", (np.array([[[1.0, 0.0], [0.0, 1.0]]], np.float32),
                                               np.array([[[1.0, 0.0], [1.0, 0.0]]], np.float32),
                                               np.array([[True, True]])), {"t": 0.8}),
        "rel_mimic_l1": ("rel_mimic_l1", (np.array([[[2.0, 0.0]]], np.float32),
                                          np.array([[[0.0, 1.0]]], np.float32),
                                          np.array([[True]])), {}),
        "triplet_distill": ("triplet_distill_loss", (
            rng.randn(1, 3, 4).astype(np.float32), rng.rand(1, 4, 5).astype(np.float32),
            rng.randn(1, 3, 4).astype(np.float32), rng.rand(1, 4, 5).astype(np.float32),
            ei, np.array([[True, True, True, False]])), {}),
    }
    for mode in ("DYNAMIC", "BG", "OCCU", "NONE"):
        cases[f"resolve_{mode}"] = ("resolve_rel_weights", (mode, gt, gt_mask),
                                    {"w_bg": 0.4, "weights_rel": w[:3]})
    cases["resolve_DYNAMIC_single"] = ("resolve_rel_weights", ("DYNAMIC", onehot, oh_mask),
                                       {"multi_rel": False})
    for k, (x, m) in _mask_cases().items():
        cases[f"masked_mean_{k}"] = ("masked_mean", (x, m), {})
    logits = rng.randn(3, 8, 5).astype(np.float32)
    cases["cross_entropy"] = ("cross_entropy", (logits, rng.randint(0, 5, (3, 8)),
                                                rng.rand(3, 8) > 0.3), {})
    return cases


PART_CASES = _part_cases()


@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_loss_part_matches_jax(case):
    name, args, kw = PART_CASES[case]
    conv = lambda f: lambda a: f(a) if isinstance(a, np.ndarray) else a
    want = getattr(JL, name)(*map(conv(jnp.asarray), args),
                             **{k: conv(jnp.asarray)(v) for k, v in kw.items()})
    got = getattr(TL, name)(*map(conv(torch.from_numpy), args),
                            **{k: conv(torch.from_numpy)(v) for k, v in kw.items()})
    if want is None:
        assert got is None
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_loss_gradients_match_jax():
    """d(total)/d(outputs) of the flagship objective (DYNAMIC, with mimic)."""
    out, jb = _loss_inputs(4)
    want = jax.grad(lambda o: JL.vlsat_total_loss(o, jb)[0])(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    TL.vlsat_total_loss(tout, to_torch(jb))[0].backward()
    for k, w in want.items():
        g = tout[k].grad
        g = np.zeros_like(out[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-7, err_msg=k)


# --------------------------------------------------------------- BatchNorm

BN_CASES = {
    "padded_rows": lambda rng: rng.rand(3, 8) > 0.4,
    "one_valid_row": lambda rng: np.eye(1, 24, 5, dtype=bool).reshape(3, 8),
    "all_padded": lambda rng: np.zeros((3, 8), bool),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_training_path_matches_flax(case):
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 8, 6) * 2 + 1).astype(np.float32)
    mask = BN_CASES[case](rng)
    stats = {"mean": rng.randn(6).astype(np.float32), "var": rng.rand(6).astype(np.float32) + 0.5}
    params = {"scale": rng.rand(6).astype(np.float32) + 0.5, "bias": rng.randn(6).astype(np.float32)}
    r = rng.randn(3, 8, 6).astype(np.float32)

    def flax_loss(p, x):
        y, upd = FlaxBN(6).apply({"params": p, "batch_stats": stats}, x, jnp.asarray(mask),
                                 use_running_average=False, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (gp, gx) = jax.value_and_grad(
        flax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = MaskedBatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    tx = torch.from_numpy(x).requires_grad_()
    y = bn(tx, torch.from_numpy(mask))
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **LOSS_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want_stats["mean"]), **LOSS_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want_stats["var"]), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4,
                               atol=1e-5)
    # eval mode normalises with the updated running statistics
    bn.eval()
    want_eval = FlaxBN(6).apply({"params": params, "batch_stats": want_stats}, jnp.asarray(x),
                                jnp.asarray(mask), use_running_average=True)
    np.testing.assert_allclose(bn(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy(),
                               np.asarray(want_eval), **LOSS_TOL)


# -------------------------------------------------- train-time outputs, grads

TRAIN_KEYS = {"obj_feature_3d_mimic": "obj", "obj_features_2d_mimic": "obj",
              "edge_feature_2d_dis": "rel", "obj_logits_3d": "obj", "obj_logits_2d": "obj",
              "rel_cls_3d": "rel", "rel_cls_2d": "rel"}


@pytest.mark.parametrize("fused", [False, True])
def test_train_time_outputs_match_jax(fused):
    jcfg = dataclasses.replace(JCFG, fused_pointnet=fused)
    jb = train_batch(2, nodes=(9, 12), bucket=12)
    params, stats = flax_variables(tuple(NARROW.items()), seed=5)
    want = FlaxMMGNet(cfg=jcfg).apply({"params": params, "batch_stats": stats}, jb,
                                      istrain=True, deterministic=True)
    model = port_model().eval()
    model.obj_encoder.fused = fused
    with torch.no_grad():
        got = model(to_torch(jb), istrain=True)
    assert sorted(got) == sorted([*TRAIN_KEYS, "logit_scale"])
    masks = {"obj": np.asarray(jb.obj_mask), "rel": np.asarray(jb.edge_mask)}
    for key, kind in TRAIN_KEYS.items():
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        m = masks[kind]
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(got["logit_scale"].numpy(), np.asarray(want["logit_scale"]),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="inference mode"):
        model(to_torch(jb), istrain=True, branch_3d_only=True)


def _port_grads(model: MMGNet) -> dict:
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    return dict(leaves(state_dict_to_flax(grads)[0]))


def test_loss_gradients_through_model_match_jax():
    """d vlsat_total_loss / d params in JAX's istrain=True,
    deterministic=True mode against model.eval() + istrain=True."""
    jb = train_batch(6, nodes=(9, 12), bucket=12)
    params, stats = flax_variables(tuple(NARROW.items()), seed=5)

    def loss(p):
        out = FlaxMMGNet(cfg=JCFG).apply({"params": p, "batch_stats": stats}, jb,
                                         istrain=True, deterministic=True)
        return JL.vlsat_total_loss(out, jb)[0]

    want = dict(leaves(jax.grad(loss)(params)))
    model = port_model().eval()
    tb = to_torch(jb)
    TL.vlsat_total_loss(model(tb, istrain=True), tb)[0].backward()
    assert all(p.grad is None for p in model.clip_adapter.parameters())
    assert all(np.abs(w).max() == 0 for k, w in want.items() if k.startswith("clip_adapter"))
    assert_grad_gate(_port_grads(model), want)


def test_text_table_initialises_cosine_classifiers():
    table = np.random.RandomState(0).randn(JCFG.num_obj_classes, JCFG.dim_node).astype(np.float32)
    jb = train_batch(0, nodes=(3,), bucket=4)
    v = FlaxMMGNet(cfg=JCFG, obj_text_features=table).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jb, istrain=True)
    model = build_mmgnet(CFG, device="cpu", obj_text_features=table)
    for head in ("obj_predictor_3d", "obj_predictor_2d"):
        np.testing.assert_array_equal(np.asarray(v["params"][head]["kernel"]).T, table)
        np.testing.assert_array_equal(getattr(model, head).weight.detach().numpy(), table)


# ------------------------------------------------------ groups and schedule

@pytest.mark.parametrize("freeze", [False, True])
def test_param_groups_equal_jax_labels(freeze):
    params, _ = flax_variables(tuple(NARROW.items()), seed=5)
    want = dict(leaves(JO.label_params(params, freeze_non_predictor=freeze)))
    model = MMGNet(CFG)
    paths = flax_paths(model)
    got = {paths[n]: g for n, g in label_params(
        (n for n, _ in model.named_parameters()), freeze).items()}
    assert got == {k: str(v) for k, v in want.items()}
    groups = make_optimizer(freeze_non_predictor=freeze).param_groups(model)
    in_opt = {n for g in groups for n in g["names"]}
    assert in_opt == {n for n, _ in model.named_parameters()
                      if label_params([n], freeze)[n] != "frozen"}


JAX_SCALES = {"base": 1.0, "mmg_obj": 0.25, "mmg_rel": 0.5, "obj_predictor": 0.1}


@pytest.mark.parametrize("schedule", ["Cosine", "BatchMultiplicative"])
def test_group_rates_follow_optax(schedule):
    """Per-group rates at t = 0, 1, T/2, T and T + 5: the update of a unit
    gradient (Adam's normalised step is 1, so the update is the rate) in
    optax and in the port (parameters zeroed before each port step, so the
    update is read without cancellation), and the port's rates against
    optax's schedule."""
    lr, T = 1e-2, 10
    params, _ = flax_variables(tuple(NARROW.items()), seed=5)
    jopt = JO.make_optimizer(lr=lr, max_iteration=T, schedule=schedule)
    jlabels = dict(leaves(JO.label_params(params)))
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    jstate = jopt.init(params)
    model = port_model()
    paths = flax_paths(model)
    spec = make_optimizer(lr=lr, max_iteration=T, schedule=schedule)
    state = create_train_state(model, spec)
    checked = 0
    for t in range(T + 6):
        updates, jstate = jopt.update(ones, jstate, params)
        jup = dict(leaves(updates))
        for group in state.optimizer.param_groups:
            base = lr * JAX_SCALES[group["label"]]
            sched = (optax.cosine_decay_schedule(base, T) if schedule == "Cosine"
                     else JO.batch_multiplicative_schedule(base))
            np.testing.assert_allclose(group["lr"], float(sched(t)), rtol=1e-6, atol=1e-12)
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
                p.grad = torch.ones_like(p)
        spec.update(state.optimizer, state.scheduler)
        if t not in (0, 1, T // 2, T, T + 5):
            continue
        for n, p in model.named_parameters():
            want = jup[paths[n]]
            if jlabels[paths[n]] == "frozen":
                assert np.all(want == 0) and np.all(p.detach().numpy() == 0), n
            else:
                got = p.detach().numpy()
                got = got.T if got.ndim == 2 and want.shape != got.shape else got
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12,
                                           err_msg=f"{n} at t={t}")
                checked += 1
    assert checked > 0


# ------------------------------------------------------------- trajectories

class _SGD:
    """Plain SGD in the spec interface of ``make_optimizer``'s result."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, model):
        opt = torch.optim.SGD(model.parameters(), lr=self.lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 1.0)

    update = staticmethod(lambda optimizer, scheduler: (optimizer.step(), scheduler.step()))


OPTIMIZERS = {  # name -> (JAX optimizer, port spec, lr)
    "adamw": lambda: (JO.make_optimizer(lr=1e-3, max_iteration=50),
                      make_optimizer(lr=1e-3, max_iteration=50), 1e-3),
    "sgd": lambda: (optax.sgd(1e-2), _SGD(1e-2), 1e-2),
}
# parameters and BatchNorm statistics after 3 steps: (rtol, atol).  Under
# AdamW the statistics inherit the parameters' lr-sized noise through
# mlp_3d_fc (observed 2.7e-4 on the running mean).
STATE_TOL = {"adamw": ((0, 3e-3), (1e-4, 1e-3)), "sgd": ((1e-3, 5e-5), (1e-4, 1e-6))}


def _jax_run(jb_list, opt, steps_from=None):
    params, stats = flax_variables(tuple(NARROW.items()), seed=5)
    state = steps_from
    if state is None:
        state = JaxState(params=params, batch_stats=stats, opt_state=opt.init(params),
                         step=jnp.zeros((), jnp.int32))
    step = jax_train_step(FlaxMMGNet(cfg=JCFG), opt, donate=False)
    losses = []
    for b in jb_list:
        state, aux = step(state, b, jax.random.PRNGKey(0))
        losses.append(float(aux["loss"]))
    return state, losses


def _assert_states_close(port_state, jstate, tol):
    (p_rtol, p_atol), (s_rtol, s_atol) = tol
    params, stats = state_dict_to_flax(port_state.model.state_dict())
    got, got_s = dict(leaves(params)), dict(leaves(stats))
    for k, w in leaves(jstate.params):
        np.testing.assert_allclose(got[k], w, rtol=p_rtol, atol=p_atol, err_msg=k)
    for k, w in leaves(jstate.batch_stats):
        np.testing.assert_allclose(got_s[k], w, rtol=s_rtol, atol=s_atol, err_msg=k)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_step_trajectory_matches_jax(flax_no_dropout, name):
    """Dropout off on both sides, BatchNorm on batch statistics."""
    jopt, spec, lr = OPTIMIZERS[name]()
    batches = [train_batch(s) for s in (20, 21, 22)]
    jstate, jlosses = _jax_run(batches, jopt)
    model = no_dropout(port_model())
    state = create_train_state(model, spec)
    step = make_train_step(model, spec, device="cpu")
    losses = []
    for b in batches:
        state, aux = step(state, to_torch(b), 0)
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state.step == 3
    _assert_states_close(state, jstate, STATE_TOL[name])


def test_mid_run_jax_state_resumes_in_port(flax_no_dropout):
    """A JAX state after 2 updates, bridged (Adam moments, counts, schedule
    position), takes its third step in either package to the same place."""
    jopt, spec, _ = OPTIMIZERS["adamw"]()
    batches = [train_batch(s) for s in (30, 31, 32)]
    jmid, _ = _jax_run(batches[:2], jopt)
    jend, jlosses = _jax_run(batches[2:], jopt, steps_from=jmid)
    model = no_dropout(MMGNet(CFG))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = train_state_from_flax(tree(jmid.params), tree(jmid.batch_stats), tree(jmid.opt_state),
                                  int(jmid.step), model=model, optimizer=spec)
    assert state.step == 2 and state.scheduler.last_epoch == 2
    # the moments carried over bit for bit
    base = jmid.opt_state.inner_states["base"].inner_state[0]
    mu = dict(leaves(tree(base.mu)))
    p = model.obj_encoder.conv1.weight
    np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(),
                                  mu["obj_encoder/conv1/kernel"].T)
    assert float(state.optimizer.state[p]["step"]) == 2.0
    # and the whole bridged tree maps back bit for bit
    back = dict(leaves(state_dict_to_flax(model.state_dict())[0]))
    for k, w in leaves(tree(jmid.params)):
        np.testing.assert_array_equal(back[k], w, err_msg=k)
    _, aux = make_train_step(model, spec, device="cpu")(state, to_torch(batches[2]), 0)
    np.testing.assert_allclose(float(aux["loss"]), jlosses[0], rtol=1e-4)
    _assert_states_close(state, jend, STATE_TOL["adamw"])


def test_train_step_learns_on_the_jax_tests_batch():
    """tests/test_train_step.py:19-33 on the port: 8 steps on one batch with
    a fixed dropout seed."""
    jb = make_batch(node_counts=(4, 6), num_points=16, with_text=True,
                    num_obj_classes=20, num_rel_classes=7)
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig

    model = build_mmgnet(MMGNetConfig(num_obj_classes=20, num_rel_classes=7), device="cpu")
    spec = make_optimizer(lr=1e-3, max_iteration=1000)
    state = create_train_state(model, spec, seed=0)
    step = make_train_step(model, spec, device="cpu")
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    tb = to_torch(jb)
    losses = []
    for _ in range(8):
        state, aux = step(state, tb, 0)
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0], losses
    assert state.step == 8
    assert torch.equal(model.clip_adapter.fc1.weight, p0["clip_adapter.fc1.weight"])
    assert (model.obj_encoder.conv1.weight - p0["obj_encoder.conv1.weight"]).abs().max() > 0
    # the trained state evaluates without a copy
    variables = state.model.state_dict()
    assert variables["obj_encoder.conv1.weight"].data_ptr() == \
        model.obj_encoder.conv1.weight.data_ptr()
    got = make_eval_step(model, device="cpu")(variables, tb)
    with torch.no_grad():
        want = model.eval()(tb)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------ dropout, multi-step, text

def _fresh(seed_weights=3):
    model = build_mmgnet(CFG, device="cpu", seed=seed_weights)
    spec = make_optimizer(lr=1e-3, max_iteration=100)
    return model, spec, create_train_state(model, spec)


def test_train_step_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model, spec, _ = _fresh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, spec)
    with pytest.raises(ValueError, match="unknown LR schedule"):
        create_train_state(model, make_optimizer(schedule="Step"))


def test_dropout_is_reproducible_from_the_seed():
    tb = to_torch(train_batch(8))
    runs = {}
    for tag, rng in (("a", 7), ("b", 7), ("c", 8)):
        model, spec, state = _fresh()
        _, aux = make_train_step(model, spec, device="cpu")(state, tb, rng)
        runs[tag] = (aux["loss"], model.state_dict())
    assert torch.equal(runs["a"][0], runs["b"][0])
    assert all(torch.equal(v, runs["b"][1][k]) for k, v in runs["a"][1].items())
    assert not torch.equal(runs["a"][0], runs["c"][0])
    model, spec, state = _fresh()
    with pytest.raises(ValueError, match="torch.Generator"):
        model.train()(tb, istrain=True)


def test_multi_step_equals_single_steps():
    batches = [to_torch(train_batch(s)) for s in (40, 41, 42)]
    model_a, spec, state_a = _fresh()
    state_a, aux = make_multi_train_step(model_a, spec, device="cpu")(
        state_a, stack_batches(batches), 9)
    model_b, spec, state_b = _fresh()
    step = make_train_step(model_b, spec, device="cpu")
    losses = []
    for i, b in enumerate(batches):
        state_b, aux_b = step(state_b, b, fold_in(9, i))
        losses.append(aux_b["loss"])
    assert torch.equal(aux["losses"], torch.stack(losses))
    assert torch.equal(aux["loss"], losses[-1])
    assert state_a.step == state_b.step == 3
    sd = model_b.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in model_a.state_dict().items())


def test_text_table_route_equals_dense_targets():
    jb = train_batch(12)
    rng = np.random.RandomState(12)
    table = rng.randn(9, TEXT_DIM).astype(np.float32)
    table[0] = 0.0
    idx = rng.randint(1, 9, (jb.num_scenes, jb.num_edges)).astype(np.int32)
    idx *= np.asarray(jb.edge_mask)
    dense = to_torch(jb.replace(rel_text_feat=jnp.asarray(table[idx])))
    compact = to_torch(jb.replace(rel_text_feat=None)).replace(rel_text_idx=torch.from_numpy(idx))
    model_a, spec, state_a = _fresh()
    _, aux_a = make_train_step(model_a, spec, device="cpu")(state_a, dense, 1)
    model_b, spec, state_b = _fresh()
    _, aux_b = make_train_step(model_b, spec, text_table=table, device="cpu")(state_b, compact, 1)
    for k in aux_a:
        assert torch.equal(aux_a[k], aux_b[k]), k
    assert aux_a["rel_mimic_loss_2d"] > 0


# -------------------------------------------------------------- checkpoints

def _trained(steps: int):
    model, spec, state = _fresh()
    step = make_train_step(model, spec, device="cpu")
    tb = to_torch(train_batch(50))
    for i in range(steps):
        step(state, tb, i)
    return model, spec, state


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    assert sa["scheduler"] == sb["scheduler"]
    oa, ob = sa["optimizer"], sb["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"]) and oa["state"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    _, _, state = _trained(3)
    CheckpointManager(str(tmp_path)).save(state)
    _, _, fresh = _fresh(seed_weights=11)
    restored = CheckpointManager(str(tmp_path)).restore(fresh)
    assert restored is fresh
    _assert_same_state(fresh, state)


def test_checkpoint_keeps_latest_best_and_unscored(tmp_path):
    _, _, state = _trained(1)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.restore(state) is None and mgr.restore(state, best=True) is None
    for s, metric in [(1, None), (2, 0.9), (3, 0.2), (4, 0.3), (5, 0.1)]:
        state.step = s
        mgr.save(state, eva_res=metric)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt"))
    assert files == ["ckpt_1.pt", "ckpt_2.pt", "ckpt_4.pt", "ckpt_5.pt"]
    assert mgr.latest_step == 5 and mgr.best_step == 2
    reopened = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert reopened.best_step == 2 and reopened.restore(state, best=True).step == 2
    assert reopened.restore(state).step == 5
    with open(tmp_path / "index.json") as f:
        assert json.load(f) == {"1": None, "2": 0.9, "4": 0.3, "5": 0.1}


def test_checkpoint_best_falls_back_to_latest(tmp_path):
    _, _, state = _trained(1)
    mgr = CheckpointManager(str(tmp_path))
    for s in (1, 2):
        state.step = s
        mgr.save(state)
    assert mgr.best_step is None and mgr.restore(state, best=True).step == 2


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    _, _, state = _trained(2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, eva_res=0.5)
    before = (tmp_path / "ckpt_2.pt").read_bytes()

    def broken_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(state, eva_res=0.7)
    assert (tmp_path / "ckpt_2.pt").read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2.pt", "index.json"]
    assert CheckpointManager(str(tmp_path)).best_step == 2


def test_checkpoint_archive_stale(tmp_path):
    _, _, state = _trained(1)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    archived = mgr.archive_stale()
    assert os.path.exists(os.path.join(archived, "ckpt_1.pt"))
    assert mgr.latest_step is None and os.listdir(tmp_path / "ck") == []
