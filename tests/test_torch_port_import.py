"""The port's reference-checkpoint import (``vlsat_tpu_torch.interop.
torch_import``) against the JAX package's, on the CPU.

The state dicts are those of the randomly initialised torch oracles of the
reference forward that the JAX package ships
(``vlsat_tpu/interop/torch_oracle.py``), with non-trivial BatchNorm
statistics.  Gates: every import tree equal to the JAX importer's, leaf for
leaf and bit for bit; the port's forward on the imported weights against
the oracle's at the gate of tests/test_parity_torch.py (fp32, rtol 1e-3,
atol 1e-4), on one scene (the oracles run one unpadded scene) padded to a
bucket.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_port_model import to_torch
from tests.test_torch_port_train import leaves
from vlsat_tpu.data.synthetic import make_batch
from vlsat_tpu.interop import torch_import as JI
from vlsat_tpu.interop import torch_oracle as TO
from vlsat_tpu.scene import edge_count
from vlsat_tpu_torch.interop import torch_import as PI
from vlsat_tpu_torch.models.gnn import TripletGCN
from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig
from vlsat_tpu_torch.models.variants import SGFN, MMGNetSingle, SGFNConfig

RTOL, ATOL = 1e-3, 1e-4


def _with_stats(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.5)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return model.eval()


@functools.lru_cache(maxsize=None)
def oracle(kind: str):
    """(oracle, per-module state dicts) of one seeded oracle."""
    torch.manual_seed({"mmgnet": 0, "single": 4, "sgfn": 6, "triplet": 5}[kind])
    if kind == "mmgnet":
        o = _with_stats(TO.TorchMmgnetOracle(), 1)
        return o, TO.module_state_dicts(o)
    if kind == "single":
        o = _with_stats(TO.TorchMmgnetSingleOracle(), 5)
        return o, TO.single_module_state_dicts(o)
    if kind == "sgfn":
        o = _with_stats(TO.TorchSGFNOracle(), 7)
        return o, TO.sgfn_module_state_dicts(o)
    o = _with_stats(TO._TripletGCN(dim_node=32, dim_edge=16, dim_hidden=64), 6)
    return o, {k: v.detach().numpy() for k, v in o.state_dict().items()}


IMPORTS = {  # name -> (oracle kind, call(import module, state dicts))
    "adapter": ("mmgnet", lambda m, s: m.import_adapter(s["clip_adapter"])),
    "pointnet": ("mmgnet", lambda m, s: m.import_pointnet(s["obj_encoder"])),
    "mha": ("mmgnet", lambda m, s: m.import_mha(s["mmg"], "cross_attn_rel.1")),
    "gean": ("mmgnet", lambda m, s: m.import_gean(s["mmg"], "gcn_2ds.0")),
    "dist_mlp": ("mmgnet", lambda m, s: m.import_dist_mlp(s["mmg"], "self_attn_fc")),
    "mmg": ("mmgnet", lambda m, s: m.import_mmg(s["mmg"])),
    "rel_predictor": ("mmgnet", lambda m, s: m.import_rel_predictor(s["rel_predictor_2d"])),
    "mmgnet": ("mmgnet", lambda m, s: m.import_mmgnet(s)),
    "triplet_gcn": ("triplet", lambda m, s: m.import_triplet_gcn(s)),
    "mmgnet_single": ("single", lambda m, s: m.import_mmgnet_single(s)),
    "sgfn": ("sgfn", lambda m, s: m.import_sgfn(s)),
}


def assert_same_tree(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.mark.parametrize("name", sorted(IMPORTS))
def test_import_tree_equals_jax(name):
    kind, call = IMPORTS[name]
    _, sds = oracle(kind)
    assert_same_tree(call(PI, sds), call(JI, sds))


def _scene(seed: int, n: int, bucket: int):
    """One scene padded to ``bucket`` (the port's input) and its unpadded
    rows (the oracle's)."""
    batch = make_batch(seed=seed, node_counts=(n,), num_points=32, bucket=bucket)
    e = edge_count(n)
    t = lambda x: torch.from_numpy(np.asarray(x)).float()
    return batch, dict(obj_points=t(batch.obj_points[0, :n]),
                       obj_2d_feats=t(batch.obj_2d_feats[0, :n]),
                       edge_index=torch.from_numpy(np.asarray(batch.edge_index[0, :e])).long(),
                       descriptor=t(batch.descriptor[0, :n]),
                       batch_ids=torch.zeros(n, dtype=torch.long))


def _close(got, want, key):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=RTOL,
                               atol=ATOL, err_msg=key)


@pytest.mark.parametrize("kind", ["mmgnet", "single", "sgfn"])
def test_imported_forward_matches_oracle(kind):
    o, sds = oracle(kind)
    n, bucket = {"mmgnet": (9, 12), "single": (10, 12), "sgfn": (11, 12)}[kind]
    batch, inp = _scene(3, n, bucket)
    if kind == "mmgnet":
        model, variables = MMGNet(MMGNetConfig()), PI.import_mmgnet(sds)
        with torch.no_grad():
            want = o(istrain=True, **inp)
    elif kind == "single":
        model, variables = MMGNetSingle(MMGNetConfig()), PI.import_mmgnet_single(sds)
        with torch.no_grad():
            want = o(inp["obj_points"], inp["edge_index"], inp["descriptor"], istrain=True)
    else:
        model, variables = SGFN(SGFNConfig()), PI.import_sgfn(sds)
        with torch.no_grad():
            want = o(inp["obj_points"], inp["edge_index"], inp["descriptor"],
                     inp["batch_ids"])
    model.load_state_dict(PI.to_state_dict(variables, model))
    with torch.no_grad():
        got = model.eval()(to_torch(batch), istrain=kind != "sgfn")
    e = edge_count(n)
    for key, w in want.items():
        g = got[key]
        if w.dim() == 0:
            _close(g, w, key)
        else:
            _close(g[0, :n if key.startswith("obj") else e], w, key)


def test_imported_triplet_gcn_matches_oracle():
    """The port's ``TripletGCN`` on the oracle's imported weights, at the
    padded case of tests/test_parity_torch.py:145-189."""
    from vlsat_tpu.scene import full_edge_index

    o, sd = oracle("triplet")
    variables = PI.import_triplet_gcn(sd)
    layer = TripletGCN(32, 16, 64)
    layer.load_state_dict(PI.to_state_dict(variables, layer))
    rng = np.random.RandomState(2)
    n, bucket = 6, 8
    ei_v = full_edge_index(n)
    ev, e_max = len(ei_v), edge_count(bucket)
    x = rng.randn(1, bucket, 32).astype(np.float32)
    e_feat = rng.randn(1, e_max, 16).astype(np.float32)
    ei = np.zeros((1, e_max, 2), np.int32)
    ei[0, :ev] = ei_v
    em = np.zeros((1, e_max), bool)
    em[0, :ev] = True
    with torch.no_grad():
        got_x, got_e = layer.eval()(*(torch.from_numpy(a) for a in (x, e_feat, ei, em)))
        want_x, want_e = o(torch.from_numpy(x[0, :n]), torch.from_numpy(e_feat[0, :ev]),
                           torch.from_numpy(ei_v).long())
    _close(got_x[0, :n], want_x, "node update")
    _close(got_e[0, :ev], want_e, "edge update")


def test_import_from_directory_round_trips(tmp_path):
    """``torch.save`` files in the reference naming (one per module), one
    behind nn.DataParallel's ``module.`` prefix and one wrapped in
    ``{"model": ...}``: both importers read the same tree, and the port's
    state_dict drives the oracle's forward."""
    o, sds = oracle("mmgnet")
    for i, (name, sd) in enumerate(sds.items()):
        sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
        if i == 0:
            sd = {f"module.{k}": v for k, v in sd.items()}
        elif i == 1:
            sd = {"model": sd}
        torch.save(sd, tmp_path / f"{name}.pth")
    got = PI.import_from_directory(str(tmp_path))
    assert_same_tree(got, JI.import_from_directory(str(tmp_path)))
    assert_same_tree(got, PI.import_mmgnet(sds))
    model = MMGNet(MMGNetConfig())
    model.load_state_dict(PI.state_dict_from_directory(str(tmp_path), model))
    batch, inp = _scene(8, 7, 8)
    with torch.no_grad():
        want = o(istrain=False, **inp)
        out = model.eval()(to_torch(batch))
    for key in ("obj_logits_3d", "obj_logits_2d"):
        _close(out[key][0, :7], want[key], key)
    for key in ("rel_cls_3d", "rel_cls_2d"):
        _close(out[key][0, :edge_count(7)], want[key], key)


def test_load_state_dict_refuses_pickled_code(tmp_path):
    """``weights_only=True``: a file that needs arbitrary unpickling is
    refused, where tensors and containers load."""
    torch.save({"w": torch.ones(2)}, tmp_path / "ok.pth")
    np.testing.assert_array_equal(PI.load_state_dict(str(tmp_path / "ok.pth"))["w"], [1, 1])
    torch.save({"w": torch.ones(2), "f": functools.partial(print)}, tmp_path / "code.pth")
    with pytest.raises(Exception, match="Weights only load failed"):
        PI.load_state_dict(str(tmp_path / "code.pth"))


def test_to_state_dict_refuses_unfilled_and_unknown_slots():
    _, sds = oracle("mmgnet")
    model = MMGNet(MMGNetConfig())
    partial = {k: v for k, v in sds.items() if k != "triplet_projector_2d"}
    with pytest.raises(KeyError, match="no flax leaf"):
        PI.to_state_dict(PI.import_mmgnet(partial), model)
    variables = PI.import_mmgnet(sds)
    variables["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="has no slot"):
        PI.to_state_dict(variables, model)
