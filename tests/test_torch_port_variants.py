"""The port's model zoo against the JAX package's, on the CPU: every ported
registry entry (``MmgnetSingle``, ``SGFN``, ``SGPN``, ``MMteacher``,
``MmgnetIn21k``) built by both registries from one MODEL section, the
flax weights bridged with ``interop.from_flax``; then the config switches,
``RelPredictorMulti2``, the transformer extras and ``TripletGCNModel``.

Inputs come from one numpy seed at the sizes of tests/test_variants.py
(node counts (4, 6), 16 points, 20 objects, 7 predicates).  Gates: outputs,
losses and running statistics at the gate of tests/test_parity_torch.py
(fp32, rtol 1e-3, atol 1e-4); a loss on identical inputs at rtol 1e-5;
gradients at tests/test_torch_port_train.py's per-leaf gate; parameter
groups and configs exactly.  Dropout is off on both sides where a forward
runs in training mode (flax's ``Dropout`` patched to identity, the port's
``p`` set to 0).
"""

from __future__ import annotations

import dataclasses
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import NARROW, port_config, to_torch
from tests.test_torch_port_train import assert_grad_gate, flax_paths, leaves, no_dropout
from vlsat_tpu.config import load_config as jax_load_config
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.models import MMGNet as FlaxMMGNet
from vlsat_tpu.models import MMGNetConfig as FlaxConfig
from vlsat_tpu.models import gnn as JG
from vlsat_tpu.models import transformer as JT
from vlsat_tpu.models.mmgnet import RelPredictorMulti2 as FlaxMulti2
from vlsat_tpu.models.registry import build_model as jax_build_model
from vlsat_tpu.scene import full_edge_index
from vlsat_tpu.train import optim as JO
from vlsat_tpu_torch.config import load_config
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from vlsat_tpu_torch.models import gnn as PG
from vlsat_tpu_torch.models import transformer as PT
from vlsat_tpu_torch.models.mmgnet import MMGNet, RelPredictorMulti2
from vlsat_tpu_torch.models.registry import build_model
from vlsat_tpu_torch.models.variants import SGPN, SGPNConfig
from vlsat_tpu_torch.train.optim import label_params, make_optimizer
from vlsat_tpu_torch.train.state import create_train_state
from vlsat_tpu_torch.train.step import has_3d_only_mode, make_eval_step

RTOL, ATOL = 1e-3, 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
NUM_OBJ, NUM_REL = 20, 7
MODEL = {"N_LAYERS": 2, "DIM_ATTEN": 32, "NUM_HEADS": 4}
NAMES = ("MmgnetSingle", "SGFN", "SGPN", "MMteacher", "MmgnetIn21k")
# registry cases: (name, MODEL overrides); USE_SPATIAL=false builds in JAX
# for the two variants whose graph stack takes the narrower nodes
CASES = {name: (name, {}) for name in NAMES}
CASES.update({"MmgnetSingle_no_spatial": ("MmgnetSingle", {"USE_SPATIAL": False}),
              "SGFN_no_spatial": ("SGFN", {"USE_SPATIAL": False})})
OBJ_KEYS = ("obj_logits", "obj_feature", "obj_features", "obj_2d_feats")


def tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def model_section(**over):
    return {**MODEL, **over}


def batch_for(name: str, seed: int = 0):
    """The tests' batch; in21k reads 768-d 2D features, SGPN union clouds
    of 16 points (xyz and a membership mask, zero on padded edges)."""
    b = make_batch(seed=seed, node_counts=(4, 6), num_points=16,
                   feat_dim=768 if name == "MmgnetIn21k" else 512,
                   num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, with_text=True)
    if name == "SGPN":
        rng = np.random.RandomState(seed + 50)
        pts = rng.randn(b.num_scenes, b.num_edges, 16, 4).astype(np.float32)
        pts[..., 3] = rng.rand(*pts.shape[:-1]) > 0.5
        b = b.replace(rel_points=jnp.asarray(pts * np.asarray(b.edge_mask)[..., None, None]))
    return b


@functools.lru_cache(maxsize=None)
def jax_side(case: str):
    """The JAX registry's model and loss, and flax variables from an
    ``istrain=True`` init with non-trivial BatchNorm statistics."""
    name, over = CASES[case]
    jmodel, jloss = jax_build_model(name, NUM_OBJ, NUM_REL,
                                    jax_load_config(overrides={"MODEL": model_section(**over)}).MODEL)
    v = jmodel.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                    batch_for(name), istrain=True)
    rng = np.random.RandomState(7)
    stats = tree(v.get("batch_stats", {}))
    for path, arr in leaves(stats):
        *mods, leaf = path.split("/")
        node = stats
        for m in mods:
            node = node[m]
        node[leaf] = (rng.randn(*arr.shape) * 0.5 if leaf == "mean"
                      else rng.rand(*arr.shape) + 0.5).astype(np.float32)
    return jmodel, jloss, tree(v["params"]), stats


def port_side(case: str):
    name, over = CASES[case]
    _, _, params, stats = jax_side(case)
    model, loss = build_model(name, NUM_OBJ, NUM_REL,
                              load_config(overrides={"MODEL": model_section(**over)}).MODEL)
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return model, loss


def kind(key: str) -> str:
    return "obj" if key.startswith(OBJ_KEYS) else "rel"


def assert_outputs_match(got, want, batch):
    assert sorted(got) == sorted(want)
    masks = {"obj": np.asarray(batch.obj_mask), "rel": np.asarray(batch.edge_mask)}
    for key, w in want.items():
        g, w = got[key].detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, key
        if g.ndim == 0:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
            continue
        m = masks[kind(key)]
        assert np.isfinite(g[m]).all(), key
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.fixture
def flax_no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


# ------------------------------------------------------- registry variants

@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_eval_forward_matches_jax(case):
    """The eval forward through ``make_eval_step`` (segment-max on its
    kernel route, here the plain twin) against ``apply(istrain=False)``."""
    jmodel, _, params, stats = jax_side(case)
    b = batch_for(CASES[case][0])
    want = jmodel.apply({"params": params, "batch_stats": stats}, b, istrain=False)
    model, _ = port_side(case)
    got = make_eval_step(model, device="cpu")(model.state_dict(), to_torch(b))
    assert_outputs_match(got, want, b)


@pytest.mark.parametrize("name", NAMES)
def test_variant_train_time_outputs_match_jax(name):
    """``istrain=True`` with running statistics and no dropout: JAX's
    ``deterministic=True`` against the port's eval mode."""
    jmodel, _, params, stats = jax_side(name)
    b = batch_for(name)
    want = jmodel.apply({"params": params, "batch_stats": stats}, b, istrain=True,
                        deterministic=True)
    model, _ = port_side(name)
    with torch.no_grad():
        got = model.eval()(to_torch(b), istrain=True)
    assert_outputs_match(got, want, b)


@pytest.mark.parametrize("name", NAMES)
def test_variant_training_forward_matches_jax(flax_no_dropout, name):
    """Training mode: batch-statistics BatchNorm, dropout off; the outputs
    and the moved running statistics."""
    jmodel, _, params, stats = jax_side(name)
    b = batch_for(name)
    want, moved = jmodel.apply({"params": params, "batch_stats": stats}, b, istrain=True,
                               mutable=["batch_stats"])
    model, _ = port_side(name)
    no_dropout(model).train()
    with torch.no_grad():
        got = model(to_torch(b), istrain=True)
    assert_outputs_match(got, want, b)
    _, got_stats = state_dict_to_flax(model.state_dict())
    want_stats = dict(leaves(tree(moved["batch_stats"])))
    assert sorted(dict(leaves(got_stats))) == sorted(want_stats)
    for path, w in want_stats.items():
        np.testing.assert_allclose(dict(leaves(got_stats))[path], w, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_variant_loss_matches_jax(name):
    """The registry's loss: on identical outputs at the loss gate, and on
    each package's own train-time outputs at the parity gate."""
    jmodel, jloss, params, stats = jax_side(name)
    b = batch_for(name)
    out = jmodel.apply({"params": params, "batch_stats": stats}, b, istrain=True,
                       deterministic=True)
    want, want_aux = jloss(out, b)
    model, loss = port_side(name)
    tb = to_torch(b)
    same, same_aux = loss({k: torch.from_numpy(np.array(v)) for k, v in out.items()}, tb)
    with torch.no_grad():
        got, got_aux = loss(model.eval()(tb, istrain=True), tb)
    assert sorted(got_aux) == sorted(same_aux) == sorted(want_aux)
    for k, w in want_aux.items():
        np.testing.assert_allclose(same_aux[k].numpy(), np.asarray(w), **LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert float(want) > 0 and np.isfinite(float(got))


def _port_grads(model) -> dict:
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    return dict(leaves(state_dict_to_flax(grads)[0]))


def _f64(t):
    """Floating leaves of a tree (a flax tree or a SceneBatch) as float64."""
    cast = lambda x: (np.asarray(x, np.float64)
                      if x is not None and np.issubdtype(np.asarray(x).dtype, np.floating)
                      else x)
    return jax.tree_util.tree_map(cast, t)


@pytest.mark.parametrize("name", NAMES)
def test_variant_train_step_gradients_match_jax(flax_no_dropout, name):
    """d loss / d params of one train step (training mode, batch-statistics
    BatchNorm, dropout off) in ``jax.grad`` and torch autograd, both in
    fp64.  In fp32 the comparison would read rounding, not the math: a
    bias in front of a batch-statistics BatchNorm has an exactly zero
    gradient (fp32 leaves ~1e-8 of noise on each side), and the BatchNorm
    backward's cancellation moves single kernel-gradient elements past the
    gate."""
    jmodel, jloss, params, stats = jax_side(name)
    with jax.enable_x64(True):
        b, p64, s64 = _f64(batch_for(name)), _f64(params), _f64(stats)

        def objective(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": s64}, b, istrain=True,
                                  mutable=["batch_stats"])
            return jloss(out, b)[0]

        want = dict(leaves(tree(jax.grad(objective)(p64))))
    assert all(w.dtype == np.float64 for w in want.values())
    model, loss = port_side(name)
    no_dropout(model).train().double()
    tb = to_torch(b)
    loss(model(tb, istrain=True), tb)[0].backward()
    assert_grad_gate(_port_grads(model), want)


@pytest.mark.parametrize("name", NAMES)
def test_variant_param_groups_equal_jax_labels(name):
    _, _, params, _ = jax_side(name)
    model, _ = port_side(name)
    paths = flax_paths(model)
    for freeze in (False, True):
        want = dict(leaves(JO.label_params(params, freeze_non_predictor=freeze)))
        got = {paths[n]: g for n, g in label_params(
            (n for n, _ in model.named_parameters()), freeze).items()}
        assert got == {k: str(v) for k, v in want.items()}, freeze


@pytest.mark.parametrize("name", ["Mmgnet", "MmgnetSingle", "MMteacher", "MmgnetIn21k"])
def test_text_table_seeds_every_cosine_classifier(name):
    """``init_parameters`` copies the text table into each classifier that
    the JAX model initialises with ``_text_kernel_init`` and into no other
    (in21k's plain heads take none)."""
    table = np.random.RandomState(0).randn(NUM_OBJ, 512).astype(np.float32)
    mcfg = load_config(overrides={"MODEL": MODEL}).MODEL
    jmodel, _ = jax_build_model(name, NUM_OBJ, NUM_REL, mcfg, obj_text_features=table)
    v = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                    batch_for(name), istrain=True)
    seeded = {k for k, p in v["params"].items()
              if isinstance(p, dict) and "kernel" in p and p["kernel"].shape == table.T.shape
              and np.array_equal(np.asarray(p["kernel"]).T, table)}
    model, _ = build_model(name, NUM_OBJ, NUM_REL, mcfg, obj_text_features=table)
    create_train_state(model, make_optimizer(), seed=0)
    got = {n.split(".")[0] for n, p in model.named_parameters()
           if p.shape == table.shape and np.array_equal(p.detach().numpy(), table)}
    assert got == seeded == set(getattr(model, "text_classifiers", ()))
    assert (name == "MmgnetIn21k") == (not got)


# -------------------------------------------------------- smaller pieces

SWITCH_CASES = {
    "in21k": dict(point_feature_size=56, cosine_classifier=False, use_adapter=False,
                  use_mlp_3d=False),
    "no_spatial": dict(use_spatial=False, use_mlp_3d=False),
    "no_adapter": dict(use_adapter=False),
    "plain_heads": dict(cosine_classifier=False),
}


@pytest.mark.parametrize("case", sorted(SWITCH_CASES))
def test_config_switches_match_jax_mmgnet(case):
    """``MMGNet`` at narrow widths with the in21k switches and
    ``use_spatial=False``: eval and train-time outputs against flax."""
    jcfg = FlaxConfig(**{**NARROW, **SWITCH_CASES[case]})
    b = make_batch(seed=1, node_counts=(4, 6), num_points=16, feat_dim=jcfg.clip_feat_dim,
                   num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL)
    v = FlaxMMGNet(cfg=jcfg).init({"params": jax.random.PRNGKey(0),
                                   "dropout": jax.random.PRNGKey(1)}, b, istrain=True)
    params, stats = tree(v["params"]), tree(v.get("batch_stats", {}))
    model = MMGNet(port_config(jcfg))
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    model.eval()
    for istrain in (False, True):
        want = FlaxMMGNet(cfg=jcfg).apply({"params": params, "batch_stats": stats}, b,
                                          istrain=istrain, deterministic=True)
        with torch.no_grad():
            got = model(to_torch(b), istrain=istrain)
        assert_outputs_match(got, want, b)
    absent = {"in21k": {"clip_adapter", "mlp_3d_fc", "obj_logit_scale"},
              "no_spatial": {"mlp_3d_fc"}, "no_adapter": {"clip_adapter"},
              "plain_heads": {"obj_logit_scale"}}[case]
    assert not absent & set(params) and not absent & {n for n, _ in model.named_children()}


def test_mmgnet_refuses_nodes_narrower_than_dim_node():
    """``use_spatial=False`` with the 768->504 bottleneck leaves 504-wide
    nodes: JAX fails inside the attention's residual, the port refuses at
    construction, and so does the registry's ``Mmgnet`` entry."""
    jcfg = FlaxConfig(**NARROW, use_spatial=False)
    b = make_batch(seed=1, node_counts=(4,), num_points=16, feat_dim=jcfg.clip_feat_dim)
    with pytest.raises(TypeError, match="broadcast"):
        FlaxMMGNet(cfg=jcfg).init({"params": jax.random.PRNGKey(0),
                                   "dropout": jax.random.PRNGKey(1)}, b, istrain=True)
    with pytest.raises(ValueError, match="dim_node"):
        MMGNet(port_config(jcfg))
    with pytest.raises(ValueError, match="dim_node"):
        build_model("Mmgnet", NUM_OBJ, NUM_REL,
                    load_config(overrides={"MODEL": model_section(USE_SPATIAL=False)}).MODEL)


def test_rel_predictor_multi2_matches_jax():
    """tests/test_misc_components.py:101-111's case, bridged."""
    x = np.random.RandomState(0).randn(2, 5, 16).astype(np.float32)
    v = FlaxMulti2(7).init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(FlaxMulti2(7).apply(v, jnp.asarray(x)))
    head = RelPredictorMulti2(16, 7)
    head.load_state_dict(flax_to_state_dict(tree(v["params"]), {}, head))
    with torch.no_grad():
        got = head.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5, 7) and (got > 0).all() and (got < 1).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("part", ["position_embedding", "sinusoid_table", "feed_forward"])
def test_transformer_extras_match_jax(part):
    """tests/test_misc_components.py:114-140's cases."""
    d_model, max_len = 64, 17
    if part == "position_embedding":
        pos = np.array([0, 3, 7, 16, 250])
        np.testing.assert_allclose(
            PT.position_embedding(torch.from_numpy(pos), d_model).numpy(),
            np.asarray(JT.position_embedding(jnp.asarray(pos), d_model)), rtol=1e-6, atol=1e-6)
    elif part == "sinusoid_table":
        for pad in (None, 0, 5):
            got = PT.sinusoid_encoding_table(max_len, d_model, padding_idx=pad).numpy()
            want = np.asarray(JT.sinusoid_encoding_table(max_len, d_model, padding_idx=pad))
            assert got.shape == (max_len, d_model)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        x = np.random.RandomState(0).randn(2, 5, 16).astype(np.float32)
        ffn = JT.PositionWiseFeedForward(d_model=16, d_ff=32)
        v = ffn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(ffn.apply(v, jnp.asarray(x)))
        port = PT.PositionWiseFeedForward(16, 32)
        port.load_state_dict(flax_to_state_dict(tree(v["params"]), {}, port))
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.mean(-1), 0.0, atol=1e-5)


def _triplet_inputs(padded: bool):
    """tests/test_variants2.py:101-116's one full scene, or two scenes of 5
    and 3 nodes padded to 5 (padded edges and nodes)."""
    rng = np.random.RandomState(0)
    n = 5
    ei = full_edge_index(n)
    if not padded:
        em = np.ones((1, len(ei)), bool)
        return (rng.randn(1, n, 32).astype(np.float32), rng.randn(1, len(ei), 64).astype(np.float32),
                ei[None].astype(np.int32), em)
    small = full_edge_index(3)
    ei2 = np.zeros_like(ei)
    ei2[:len(small)] = small
    em = np.zeros((2, len(ei)), bool)
    em[0], em[1, :len(small)] = True, True
    return (rng.randn(2, n, 32).astype(np.float32), rng.randn(2, len(ei), 64).astype(np.float32),
            np.stack([ei, ei2]).astype(np.int32), em)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_triplet_gcn_model_matches_jax(mode, padded):
    """Aggregation by add onto target = 1; nn1's BatchNorm over valid
    edges, nn2's over every node row; eval with running statistics, train
    with batch statistics and the moved running statistics."""
    x, e, ei, em = _triplet_inputs(padded)
    args = [jnp.asarray(a) for a in (x, e, ei, em)]
    jm = JG.TripletGCNModel(num_layers=2, dim_node=32, dim_edge=64, dim_hidden=48)
    v = jm.init(jax.random.PRNGKey(0), *args)
    params, stats = tree(v["params"]), tree(v["batch_stats"])
    port = PG.TripletGCNModel(2, 32, 64, 48)
    port.load_state_dict(flax_to_state_dict(params, stats, port))
    targs = [torch.from_numpy(a) for a in (x, e, ei, em)]
    if mode == "eval":
        want = jm.apply({"params": params, "batch_stats": stats}, *args, deterministic=True)
        port.eval()
    else:
        want, moved = jm.apply({"params": params, "batch_stats": stats}, *args,
                               deterministic=False, mutable=["batch_stats"])
        port.train()
    with torch.no_grad():
        got = port(*targs)
    node_rows = np.ones(x.shape[:2], bool) if not padded else np.array(
        [[True] * 5, [True] * 3 + [False] * 2])
    for g, w, m in ((got[0], want[0], node_rows), (got[1], want[1], em)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m], rtol=RTOL, atol=ATOL)
    if mode == "train":
        got_stats = dict(leaves(state_dict_to_flax(port.state_dict())[1]))
        for path, w in leaves(tree(moved["batch_stats"])):
            np.testing.assert_allclose(got_stats[path], w, rtol=RTOL, atol=ATOL, err_msg=path)


def test_sgpn_without_rel_points_raises():
    b = to_torch(batch_for("SGPN").replace(rel_points=None))
    with pytest.raises(ValueError, match="rel_points"):
        SGPN(SGPNConfig(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL)).eval()(b)


@pytest.mark.parametrize("name", NAMES)
def test_registry_config_and_loss_equal_jax(name):
    """Every config field the two packages share, the loss's bound
    keywords, and the union-cloud channel count of SGPN."""
    mcfg = load_config(overrides={"MODEL": model_section(USE_RGB=True)}).MODEL
    model, loss = build_model(name, 160, 26, mcfg)
    jmodel, jloss = jax_build_model(name, 160, 26, mcfg)
    got, want = model.cfg, jmodel.cfg
    shared = [f.name for f in dataclasses.fields(got) if hasattr(want, f.name)]
    assert len(shared) >= 5
    for field in shared:
        assert getattr(got, field) == getattr(want, field), field
    assert got.point_channels == 6 and not getattr(got, "fused_pointnet", False)
    assert getattr(loss, "keywords", None) == getattr(jloss, "keywords", None)
    assert getattr(loss, "func", loss).__name__ == getattr(jloss, "func", jloss).__name__
    if name == "SGPN":
        assert model.rel_encoder.conv1.in_features == 7
    if not has_3d_only_mode(model):
        with pytest.raises(ValueError, match="MMGNet serving mode"):
            make_eval_step(model, branch_3d_only=True, device="cpu")
