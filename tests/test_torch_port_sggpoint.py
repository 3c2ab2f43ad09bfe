"""The port's SGGpoint family against the JAX package's, on the CPU: the kNN
and EdgeConv input (``ops.dgcnn``), the GCN propagation (``ops.gcn``), the
STNs, the DGCNN and EdgeGCN blocks on the torch oracles' weights, the heads
and ``MMEdgeGCN``, then ``SGGpoint`` and ``SGGpointBaseline`` whole: eval,
train-time and batch-statistics forwards, losses, fp64 gradients, text
tables, the registry, and both runners over one epoch.

Inputs come from one numpy seed at narrow sizes (node counts (4, 6), 32
points an instance, k = 8 < P so that the kNN selects).  Gates: the parity
gate of tests/test_parity_torch.py (fp32, rtol 1e-3, atol 1e-4); losses on
identical inputs at rtol 1e-5; gradients at the per-leaf gate of
tests/test_torch_port_train.py, in fp64 on both sides; neighbour sets
counted, with no mismatch allowed at these sizes.  Dropout is off on both
sides where a forward runs in training mode.
"""

from __future__ import annotations

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import to_torch
from tests.test_torch_port_packed import assert_same_metrics
from tests.test_torch_port_runner import (bridged_runners, both_configs, events, mini,  # noqa: F401
                                          write_config)
from tests.test_torch_port_train import assert_grad_gate, flax_paths, leaves, no_dropout
from tests.torch_threads import one_thread  # noqa: F401
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.interop.torch_oracle import _DGCNN, _EdgeGCN
from vlsat_tpu.models import sggpoint as JS
from vlsat_tpu.models import stn as JSTN
from vlsat_tpu.models.registry import build_model as jax_build_model
from vlsat_tpu.ops import dgcnn as JD
from vlsat_tpu.ops import gcn as JGCN
from vlsat_tpu.scene import edge_count, full_edge_index
from vlsat_tpu.train import optim as JO
from vlsat_tpu_torch.config import load_config
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from vlsat_tpu_torch.interop.torch_import import _dense, _t, _v
from vlsat_tpu_torch.models import sggpoint as PS
from vlsat_tpu_torch.models import stn as PSTN
from vlsat_tpu_torch.models.registry import build_model
from vlsat_tpu_torch.ops import dgcnn as PD
from vlsat_tpu_torch.ops import gcn as PGCN
from vlsat_tpu_torch.train.optim import label_params, make_optimizer
from vlsat_tpu_torch.train.state import create_train_state
from vlsat_tpu_torch.train.step import make_eval_step

RTOL, ATOL = 1e-3, 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
NUM_OBJ, NUM_REL = 20, 7
K, POINTS = 8, 32
NAMES = ("SGGpoint", "SGGpointBaseline")
OBJ_KEYS = ("obj_logits", "obj_feature", "obj_features")


def tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def set_mismatches(a: np.ndarray, b: np.ndarray) -> int:
    """Rows of two (..., k) index arrays whose neighbour sets differ."""
    return int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())


class flax_dropout_off:  # noqa: N801 (a context manager used like a function)
    """flax's ``Dropout`` as the identity inside the block."""

    def __enter__(self):
        self._old = flax.linen.Dropout.__call__
        flax.linen.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x

    def __exit__(self, *exc):
        flax.linen.Dropout.__call__ = self._old


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("width", [3, 64])
def test_knn_and_graph_feature_match_jax(width):
    """tests/test_variants2.py:14-30's case, and a 64-wide point set like
    the EdgeConv stages' (where the -|x|^2 form cancels): neighbour sets
    equal to JAX's and to a sort of the distances, self first, and the
    [x_j - x_i, x_i] layout."""
    rng = np.random.RandomState(width)
    x = rng.randn(2, 3, POINTS, width).astype(np.float32)
    got = PD.knn_indices(torch.from_numpy(x), K).numpy()
    want = np.asarray(JD.knn_indices(jnp.asarray(x), K))
    assert got.shape == (2, 3, POINTS, K)
    assert set_mismatches(got, want) == 0
    d = np.square(x[..., :, None, :] - x[..., None, :, :]).sum(-1)
    assert set_mismatches(got, np.argsort(d, -1, kind="stable")[..., :K]) == 0
    assert (got[..., 0] == np.arange(POINTS)).all()
    g = PD.graph_feature(torch.from_numpy(x), k=K).numpy()
    assert g.shape == (2, 3, POINTS, K, 2 * width)
    np.testing.assert_allclose(g, np.asarray(JD.graph_feature(jnp.asarray(x), k=K)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(g[..., 0, :width], 0.0)   # the self edge
    np.testing.assert_array_equal(g[..., width:], np.broadcast_to(x[..., None, :], g[..., width:].shape))


def test_gcn_propagate_matches_jax_and_dense_oracle():
    """tests/test_variants2.py:32-50's case (some edges masked), padded to
    a second scene of 3 nodes: JAX's propagation and the dense
    D^-1/2 (A + I) D^-1/2 x."""
    rng = np.random.RandomState(1)
    n, d = 5, 4
    x = rng.randn(2, n, d).astype(np.float32)
    ei = np.zeros((2, edge_count(n), 2), np.int32)
    ei[0], ei[1, :6] = full_edge_index(n), full_edge_index(3)
    mask = np.zeros(ei.shape[:2], bool)
    mask[0, :-3], mask[1, :6] = True, True
    got = PGCN.gcn_propagate(*map(torch.from_numpy, (x, ei, mask))).numpy()
    want = np.asarray(JGCN.gcn_propagate(*map(jnp.asarray, (x, ei, mask))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for b in range(2):
        a = np.eye(n)
        for (i, j), m in zip(ei[b], mask[b]):
            if m:
                a[j, i] += 1  # message source i -> target j
        dn = np.diag(1.0 / np.sqrt(a.sum(1)))
        np.testing.assert_allclose(got[b], dn @ a @ dn @ x[b], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1, 3:], x[1, 3:], atol=1e-7)  # padded nodes: degree 1


def test_stn_identity_at_init_and_bridged_equal_jax():
    """tests/test_misc_components.py:7-25: the port's fresh STN3d is the
    identity; STNkd(16) on flax's weights (fc3 moved off zero) equals
    JAX's; ``apply_transform`` of the identity returns the points."""
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 32, 3).astype(np.float32)
    stn = PSTN.STN3d()
    with torch.no_grad():
        trans = stn(torch.from_numpy(pts))
    assert trans.shape == (2, 3, 3)
    np.testing.assert_allclose(trans.numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)), atol=1e-6)
    np.testing.assert_allclose(PSTN.apply_transform(torch.from_numpy(pts), trans).numpy(), pts,
                               atol=1e-6)
    feats = rng.randn(2, 32, 16).astype(np.float32)
    jm = JSTN.STNkd(k=16)
    params = tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(feats))["params"])
    params["fc3"]["kernel"] = (rng.randn(256, 256) * 0.01).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(feats)))
    port = PSTN.STNkd(k=16)
    port.load_state_dict(flax_to_state_dict(params, {}, port))
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    assert got.shape == (2, 16, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_feature_transform_regularizer_matches_jax():
    """tests/test_surface_tails.py:110-133: 0 on identities, the mean
    Frobenius norm of T T^t - I otherwise."""
    eye = torch.eye(4).expand(3, 4, 4)
    assert float(PSTN.feature_transform_regularizer(eye)) == 0.0
    t = np.random.RandomState(0).randn(5, 4, 4).astype(np.float32)
    got = float(PSTN.feature_transform_regularizer(torch.from_numpy(t)))
    np.testing.assert_allclose(got, float(JSTN.feature_transform_regularizer(jnp.asarray(t))),
                               rtol=1e-6)
    np.testing.assert_allclose(got, np.mean([np.linalg.norm(a @ a.T - np.eye(4)) for a in t]),
                               rtol=1e-5)


# --------------------------------------------------- blocks on the oracles

def test_dgcnn_matches_jax_on_the_oracle_weights():
    """tests/test_parity_torch.py:280's case: the official-layout DGCNN
    twin's weights (non-trivial BatchNorm statistics) carried to both
    packages; eval mode, against JAX and against the twin."""
    torch.manual_seed(9)
    n, emb = 3, 64
    twin = _DGCNN(input_channel=3, embeddings=emb, k=K).eval()
    g = torch.Generator().manual_seed(10)
    for m in twin.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.2)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    sd = {k: v.detach().numpy() for k, v in twin.state_dict().items()}
    params, stats = {}, {}
    for i in range(1, 6):
        w = sd[f"conv{i}.0.weight"]
        params[f"conv{i}_fc"] = {"kernel": _t(w.reshape(w.shape[0], w.shape[1]))}
        params[f"conv{i}_bn"] = {"scale": _v(sd[f"conv{i}.1.weight"]),
                                 "bias": _v(sd[f"conv{i}.1.bias"])}
        stats[f"conv{i}_bn"] = {"mean": _v(sd[f"conv{i}.1.running_mean"]),
                                "var": _v(sd[f"conv{i}.1.running_var"])}
    pts = np.random.RandomState(6).randn(1, n, POINTS, 3).astype(np.float32)
    mask = np.ones((1, n), bool)
    want = np.asarray(JS.DGCNN(embeddings=emb, k=K).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(pts), jnp.asarray(mask)))
    port = PS.DGCNN(3, emb, K)
    port.load_state_dict(flax_to_state_dict(params, stats, port))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
        ref = twin(torch.from_numpy(pts[0]).permute(0, 2, 1)).permute(0, 2, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], ref, rtol=RTOL, atol=ATOL)


def test_edgegcn_matches_jax_on_the_oracle_weights():
    """tests/test_parity_torch.py:234's case: the PyG-free EdgeGCN twin's
    weights in both packages; a padded scene of 6 nodes in a bucket of 8."""
    torch.manual_seed(8)
    dim, n, bucket = 64, 6, 8
    twin = _EdgeGCN(dim=dim).eval()
    sd = {k: v.detach().numpy() for k, v in twin.state_dict().items()}
    names = {"edge_attentionND": "edge_attentionND", "node_GConv1_fc": "node_GConv1.lin",
             "node_GConv2_fc": "node_GConv2.lin", "node_attentionND": "node_attentionND",
             "node_indicator_reduction": "node_indicator_reduction",
             "edge_MLP1_fc": "edge_MLP1", "edge_MLP2_fc": "edge_MLP2"}
    params = {k: _dense(sd, v) for k, v in names.items()}
    rng = np.random.RandomState(4)
    ei_v = full_edge_index(n)
    ev, e_max = len(ei_v), edge_count(bucket)
    x = rng.randn(1, bucket, dim).astype(np.float32)
    e = rng.randn(1, e_max, dim).astype(np.float32)
    ei = np.zeros((1, e_max, 2), np.int32)
    ei[0, :ev] = ei_v
    em = np.zeros((1, e_max), bool)
    em[0, :ev] = True
    jx, je = JS.EdgeGCN(dim=dim).apply({"params": params},
                                       *map(jnp.asarray, (x, e, ei, em)), deterministic=True)
    port = PS.EdgeGCN(dim)
    port.load_state_dict(flax_to_state_dict(params, {}, port))
    with torch.no_grad():
        px, pe = port.eval()(*map(torch.from_numpy, (x, e, ei, em)))
        rx, re = twin(torch.from_numpy(x[0, :n]), torch.from_numpy(e[0, :ev]),
                      torch.from_numpy(ei_v.T).long())
    np.testing.assert_allclose(px.numpy()[0, :n], np.asarray(jx)[0, :n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pe.numpy()[0, :ev], np.asarray(je)[0, :ev], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(px.numpy()[0, :n], rx.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pe.numpy()[0, :ev], re.numpy(), rtol=RTOL, atol=ATOL)


def _two_scenes(dim: int, seed: int):
    """Nodes and edges of two scenes (6 and 4 nodes) in a bucket of 8."""
    rng = np.random.RandomState(seed)
    e_max = edge_count(8)
    ei = np.zeros((2, e_max, 2), np.int32)
    em = np.zeros((2, e_max), bool)
    om = np.zeros((2, 8), bool)
    for b, n in enumerate((6, 4)):
        idx = full_edge_index(n)
        ei[b, :len(idx)], em[b, :len(idx)], om[b, :n] = idx, True, True
    return (rng.randn(2, 8, dim).astype(np.float32), rng.randn(2, e_max, dim).astype(np.float32),
            ei, em, om, rng.randn(2, 8, 3).astype(np.float32))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_edge_mlp_head_matches_jax(mode):
    """Eval with running statistics; training with the valid edges'
    statistics (dropout off) and the moved running statistics."""
    _, e, _, em, _, _ = _two_scenes(64, 2)
    jm = JS.EdgeMLPHead(NUM_REL)
    v = tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(e), jnp.asarray(em)))
    v["batch_stats"]["edge_bn"]["mean"] = v["batch_stats"]["edge_bn"]["mean"] + 0.3
    port = PS.EdgeMLPHead(64, NUM_REL)
    port.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"], port))
    if mode == "eval":
        want = jm.apply(v, jnp.asarray(e), jnp.asarray(em))
        port.eval()
    else:
        with flax_dropout_off():
            want, moved = jm.apply(v, jnp.asarray(e), jnp.asarray(em), deterministic=False,
                                   mutable=["batch_stats"])
        no_dropout(port).train()
    with torch.no_grad():
        got = port(torch.from_numpy(e), torch.from_numpy(em)).numpy()
    np.testing.assert_allclose(got[em], np.asarray(want)[em], rtol=RTOL, atol=ATOL)
    if mode == "train":
        got_stats = dict(leaves(state_dict_to_flax(port.state_dict())[1]))
        for path, w in leaves(tree(moved["batch_stats"])):
            np.testing.assert_allclose(got_stats[path], w, rtol=RTOL, atol=ATOL, err_msg=path)


def test_mm_edge_gcn_matches_jax():
    """The dual-branch block in eval mode: distance-biased self-attention,
    cross-attention, two EdgeGCNs and the masked (E x E) edge
    cross-attention, over two padded scenes."""
    dim = 64
    x, e, ei, em, om, ctr = _two_scenes(dim, 3)
    x2, e2 = x[:, ::-1].copy() * 0.5, e[:, ::-1].copy() * 0.5
    args = (x, x2, e, e2, ei, om, em, ctr)
    jm = JS.MMEdgeGCN(dim, dim, 4)
    v = tree(jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args)))
    want = jm.apply(v, *map(jnp.asarray, args))
    port = PS.MMEdgeGCN(dim, dim, 4)
    port.load_state_dict(flax_to_state_dict(v["params"], {}, port))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, args))
    for g, w, m in zip(got, want, (om, em, om, em)):
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- whole models

def batch_for(seed: int = 0):
    return make_batch(seed=seed, node_counts=(4, 6), num_points=POINTS,
                      num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, with_text=True)


def jax_config(name: str):
    dim = 512 if name == "SGGpoint" else 64
    return JS.SGGpointConfig(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL, dim=dim,
                             num_heads=4, knn_k=K)


def port_config(name: str) -> PS.SGGpointConfig:
    j = jax_config(name)
    return PS.SGGpointConfig(num_obj_classes=j.num_obj_classes, num_rel_classes=j.num_rel_classes,
                             dim=j.dim, num_heads=j.num_heads, knn_k=j.knn_k)


@functools.lru_cache(maxsize=None)
def jax_side(name: str):
    """The flax model and variables from an ``istrain=True`` init, with
    non-trivial BatchNorm statistics."""
    jmodel = getattr(JS, name)(cfg=jax_config(name))
    v = jmodel.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                    batch_for(), istrain=True)
    rng = np.random.RandomState(7)
    stats = tree(v["batch_stats"])
    for path, arr in leaves(stats):
        *mods, leaf = path.split("/")
        node = stats
        for m in mods:
            node = node[m]
        node[leaf] = (rng.randn(*arr.shape) * 0.3 if leaf == "mean"
                      else rng.rand(*arr.shape) + 0.5).astype(np.float32)
    return jmodel, tree(v["params"]), stats


def port_side(name: str):
    _, params, stats = jax_side(name)
    model = getattr(PS, name)(port_config(name))
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return model


JAX_LOSS = {"SGGpoint": JS.sggpoint_loss, "SGGpointBaseline": JS.sggpoint_baseline_loss}
PORT_LOSS = {"SGGpoint": PS.sggpoint_loss, "SGGpointBaseline": PS.sggpoint_baseline_loss}


def assert_outputs_match(got, want, batch):
    assert sorted(got) == sorted(want)
    masks = {"obj": np.asarray(batch.obj_mask), "rel": np.asarray(batch.edge_mask)}
    for key, w in want.items():
        g, w = got[key].detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, key
        if g.ndim == 0:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
            continue
        m = masks["obj" if key.startswith(OBJ_KEYS) else "rel"]
        assert np.isfinite(g[m]).all(), key
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("istrain", [False, True])
def test_model_eval_forward_matches_jax(name, istrain):
    """Eval mode (running statistics, no dropout): the eval step's outputs,
    and with ``istrain`` the train-time outputs of JAX's ``istrain=True,
    deterministic=True``."""
    jmodel, params, stats = jax_side(name)
    b = batch_for(1)
    want = jmodel.apply({"params": params, "batch_stats": stats}, b, istrain=istrain,
                        deterministic=True)
    model = port_side(name)
    if istrain:
        with torch.no_grad():
            got = model.eval()(to_torch(b), istrain=True)
    else:
        got = make_eval_step(model, device="cpu")(model.state_dict(), to_torch(b))
    assert_outputs_match(got, want, b)


@pytest.mark.parametrize("name", NAMES)
def test_model_training_forward_matches_jax(name):
    """Training mode: batch-statistics BatchNorms (the backbone's over every
    valid node's (P, k) rows), dropout off; the outputs and the moved
    running statistics."""
    jmodel, params, stats = jax_side(name)
    b = batch_for(2)
    with flax_dropout_off():
        want, moved = jmodel.apply({"params": params, "batch_stats": stats}, b, istrain=True,
                                   mutable=["batch_stats"])
    model = no_dropout(port_side(name)).train()
    with torch.no_grad():
        got = model(to_torch(b), istrain=True)
    assert_outputs_match(got, want, b)
    got_stats = dict(leaves(state_dict_to_flax(model.state_dict())[1]))
    want_stats = dict(leaves(tree(moved["batch_stats"])))
    assert sorted(got_stats) == sorted(want_stats)
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, rtol=RTOL, atol=ATOL, err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_terms_match_jax(name):
    """On identical outputs at the loss gate, and on each package's own
    train-time outputs at the parity gate; SGGpoint without text targets
    has a zero rel-mimic term."""
    jmodel, params, stats = jax_side(name)
    b = batch_for(3)
    tb = to_torch(b)
    model = port_side(name).eval()
    for batch, tbatch in ((b, tb), (b.replace(rel_text_feat=None), tb.replace(rel_text_feat=None))):
        out = jmodel.apply({"params": params, "batch_stats": stats}, batch, istrain=True,
                           deterministic=True)
        want, want_aux = JAX_LOSS[name](out, batch)
        same, same_aux = PORT_LOSS[name](
            {k: torch.from_numpy(np.array(v)) for k, v in out.items()}, tbatch)
        with torch.no_grad():
            got, got_aux = PORT_LOSS[name](model(tbatch, istrain=True), tbatch)
        assert sorted(got_aux) == sorted(same_aux) == sorted(want_aux)
        for k, w in want_aux.items():
            np.testing.assert_allclose(same_aux[k].numpy(), np.asarray(w), **LOSS_TOL, err_msg=k)
            np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        assert float(want) > 0
    assert float(same_aux.get("rel_mimic_loss_2d", torch.zeros(()))) == 0.0


def _f64(t):
    cast = lambda x: (np.asarray(x, np.float64)
                      if x is not None and np.issubdtype(np.asarray(x).dtype, np.floating)
                      else x)
    return jax.tree_util.tree_map(cast, t)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_gradients_match_jax_in_fp64(name):
    """d loss / d params of one training-mode step (batch statistics,
    dropout off) in ``jax.grad`` and torch autograd, both in fp64 (as
    tests/test_torch_port_variants.py compares them); the neighbour sets of
    every stage agree there."""
    jmodel, params, stats = jax_side(name)
    with jax.enable_x64(True), flax_dropout_off():
        b, p64, s64 = _f64(batch_for(4)), _f64(params), _f64(stats)

        def objective(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": s64}, b, istrain=True,
                                  mutable=["batch_stats"])
            return JAX_LOSS[name](out, b)[0]

        want = dict(leaves(tree(jax.grad(objective)(p64))))
    assert all(w.dtype == np.float64 for w in want.values())
    model = no_dropout(port_side(name)).train().double()
    tb = to_torch(b)
    PORT_LOSS[name](model(tb, istrain=True), tb)[0].backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    assert_grad_gate(dict(leaves(state_dict_to_flax(grads)[0])), want)


def test_text_table_seeds_both_classifiers():
    """``init_parameters`` copies the text table into ``obj_classifier_3d``
    and ``_2d``, the classifiers JAX seeds with ``_text_kernel_init``."""
    table = np.random.RandomState(0).randn(NUM_OBJ, 512).astype(np.float32)
    mcfg = load_config().MODEL
    jmodel, _ = jax_build_model("SGGpoint", NUM_OBJ, NUM_REL, mcfg, obj_text_features=table)
    v = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                    batch_for(), istrain=True)
    seeded = {k for k, p in v["params"].items()
              if isinstance(p, dict) and "kernel" in p and p["kernel"].shape == table.T.shape
              and np.array_equal(np.asarray(p["kernel"]).T, table)}
    model, _ = build_model("SGGpoint", NUM_OBJ, NUM_REL, mcfg, obj_text_features=table)
    create_train_state(model, make_optimizer(), seed=0)
    got = {n.split(".")[0] for n, p in model.named_parameters()
           if p.shape == table.shape and np.array_equal(p.detach().numpy(), table)}
    assert got == seeded == set(model.text_classifiers) == {"obj_classifier_3d",
                                                            "obj_classifier_2d"}


@pytest.mark.parametrize("name", NAMES)
def test_registry_config_loss_and_groups_equal_jax(name):
    """Every config field both packages have, the bound loss, the input
    widths torch needs, and the parameter groups of both optimizers."""
    mcfg = load_config(overrides={"MODEL": {"NUM_HEADS": 4, "USE_RGB": True}}).MODEL
    model, loss = build_model(name, 160, 26, mcfg)
    jmodel, jloss = jax_build_model(name, 160, 26, mcfg)
    assert type(model).__name__ == type(jmodel).__name__
    assert model.cfg.point_channels == 6 and model.backbone.conv1_fc.in_features == 12
    for field in ("num_obj_classes", "num_rel_classes", "dim", "num_heads", "use_spatial",
                  "knn_k"):
        assert getattr(model.cfg, field) == getattr(jmodel.cfg, field), field
    assert loss is PORT_LOSS[name] and jloss is JAX_LOSS[name]
    assert model.backbone.conv5_fc.out_features == (768 if name == "SGGpoint" else 512)
    _, params, _ = jax_side(name)
    small = port_side(name)
    paths = flax_paths(small)
    for freeze in (False, True):
        want = dict(leaves(JO.label_params(params, freeze_non_predictor=freeze)))
        got = {paths[n]: g for n, g in label_params(
            (n for n, _ in small.named_parameters()), freeze).items()}
        assert got == {k: str(v) for k, v in want.items()}, freeze


def test_sggpoint_refuses_nodes_narrower_than_dim():
    """``USE_SPATIAL=false`` leaves 504-wide 3D nodes: JAX fails in the
    attention's residual, the port refuses when built (model and
    registry); the baseline, which reads no spatial feature, builds."""
    b = batch_for()
    with pytest.raises(TypeError, match="broadcast"):
        JS.SGGpoint(cfg=JS.SGGpointConfig(num_obj_classes=NUM_OBJ, num_rel_classes=NUM_REL,
                                          use_spatial=False, knn_k=K)).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b)
    with pytest.raises(ValueError, match="not dim 512"):
        PS.SGGpoint(PS.SGGpointConfig(use_spatial=False))
    mcfg = load_config(overrides={"MODEL": {"USE_SPATIAL": False}}).MODEL
    with pytest.raises(ValueError, match="not dim 512"):
        build_model("SGGpoint", NUM_OBJ, NUM_REL, mcfg)
    assert type(build_model("SGGpointBaseline", NUM_OBJ, NUM_REL, mcfg)[0]).__name__ == \
        "SGGpointBaseline"
    # the 2D features are dim wide: the registry refuses another width
    mcfg = load_config(overrides={"MODEL": {"clip_feat_dim": 256}}).MODEL
    with pytest.raises(ValueError, match="clip_feat_dim=256"):
        build_model("SGGpoint", NUM_OBJ, NUM_REL, mcfg)


def test_runner_one_epoch_of_the_baseline_matches_jax(mini, tmp_path, monkeypatch):  # noqa: F811
    """One JSON (``NAME=SGGpointBaseline``) through both runners for one
    epoch, the port starting from the JAX runner's initial state, dropout
    off: equal logged losses at every step and equal validation metrics."""
    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    _, paths = mini
    path = write_config(tmp_path / "cfg.json", paths["unpacked"], NAME="SGGpointBaseline",
                        MAX_EPOCHES=1, VALID_INTERVAL=1)
    jcfg, pcfg = both_configs(path, tmp_path, "train")
    with flax_dropout_off():
        jr, pr = bridged_runners(jcfg, pcfg)
        try:
            jr.train()
            pr.train()
            assert pr.state.step == int(jr.state.step) > 0
        finally:
            jr.close()
            pr.close()
    got, want = events(pcfg), events(jcfg)
    losses = lambda recs: [(r["step"], r["train/loss"]) for r in recs if "train/loss" in r]
    assert [s for s, _ in losses(got)] == [s for s, _ in losses(want)]
    assert len(losses(got)) >= 2
    np.testing.assert_allclose([v for _, v in losses(got)], [v for _, v in losses(want)],
                               rtol=1e-4)
    metrics = lambda recs: [r for r in recs if "mean_recall_50" in r]
    (gm,), (wm,) = metrics(got), metrics(want)
    assert gm.pop("step") == wm.pop("step")
    gm.pop("time"), wm.pop("time")
    assert_same_metrics(gm, wm, "SGGpointBaseline")
