"""Import the reference's PyTorch checkpoints (counterpart of
``vlsat_tpu/interop/torch_import.py``).

The reference saves one ``.pth`` per direct child module
(src/model/model_utils/model_base.py:47-73).  Each ``import_*`` function
maps those state dicts onto the same flax-shaped tree of numpy arrays as
its JAX twin ({"params": ..., "batch_stats": ...}); ``to_state_dict`` turns
such a tree into the port's ``state_dict`` through ``interop.from_flax``,
and ``state_dict_from_directory`` does both for a checkpoint directory.

Layout conversions:
  * torch Linear weight (out, in)      -> flax Dense kernel (in, out)
  * torch Conv1d k=1 weight (out,in,1) -> squeeze + transpose
  * torch Conv2d 1x1 weight (out,in,1,1) -> reshape + transpose (SGGpoint)
  * LayerNorm weight/bias              -> scale/bias
  * BatchNorm1d weight/bias            -> params scale/bias;
    running_mean/var                   -> batch_stats mean/var

Reference Sequential indices (build_mlp / MLP, network_util.py:13-47):
a Linear/Conv layer sits at index 0, then activation(+dropout) layers, so
the i-th learnable layer maps to the fc{i}/conv{i} names via the index
tables below.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from vlsat_tpu_torch.interop.from_flax import tree_to_state_dict


def _t(w) -> np.ndarray:
    w = np.asarray(w, dtype=np.float32)
    if w.ndim == 3 and w.shape[-1] == 1:  # Conv1d k=1
        w = w[..., 0]
    return w.T


def _v(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` state dict as numpy arrays; a ``{"model": ...}`` wrapper
    is unwrapped and nn.DataParallel's ``module.`` prefix dropped.  Read
    with ``weights_only=True``: tensors and containers only, no code."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    out = {}
    for k, v in obj.items():
        k = k.removeprefix("module.")  # nn.DataParallel prefix (model_base.py:160-184)
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def import_adapter(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """clip_adapter/model.py AdapterModel -> ``AdapterModel`` params."""
    return {
        "fc1": {"kernel": _t(sd["fc1.weight"]), "bias": _v(sd["fc1.bias"])},
        "fc2": {"kernel": _t(sd["fc2.weight"]), "bias": _v(sd["fc2.bias"])},
    }


def _dense(sd, prefix) -> Dict[str, np.ndarray]:
    p = f"{prefix}." if prefix else ""
    return {"kernel": _t(sd[f"{p}weight"]), "bias": _v(sd[f"{p}bias"])}


def _layernorm(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": _v(sd[f"{prefix}.weight"]), "bias": _v(sd[f"{prefix}.bias"])}


def import_pointnet(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """PointNetfeat conv1..conv3 -> PointNetEncoder conv1..conv3."""
    return {f"conv{i}": _dense(sd, f"conv{i}") for i in (1, 2, 3)}


def import_mha(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """transformer MultiHeadAttention -> ``MultiHeadAttention`` params."""
    return {
        "fc_q": _dense(sd, f"{prefix}.attention.fc_q"),
        "fc_k": _dense(sd, f"{prefix}.attention.fc_k"),
        "fc_v": _dense(sd, f"{prefix}.attention.fc_v"),
        "fc_o": _dense(sd, f"{prefix}.attention.fc_o"),
        "layer_norm": _layernorm(sd, f"{prefix}.layer_norm"),
    }


def import_gean(sd: Mapping[str, np.ndarray], prefix: str,
                atten_dropout: bool = True, dim_node: int = 512,
                dim_edge: int = 512) -> Dict[str, Any]:
    """GraphEdgeAttenNetwork -> ``GraphEdgeAttenNetwork`` params.

    Sequential indices: nn_edge = [Linear0, ReLU, Linear2]; prop likewise;
    proj_* = [Linear0]; gate MLP 'nn' = [Conv0, ReLU, (Dropout), Conv_last]
    where Conv_last is index 3 with dropout, 2 without.

    The reference's nn_edge.0 operates on cat([x_i, e, x_j]); our model
    splits it by linearity into node-level i/j projections (gathered per
    edge) + an edge projection carrying the bias — the imported (1536,
    1024) kernel is split row-wise into the three parts.
    """
    gate_last = 3 if atten_dropout else 2
    ea = f"{prefix}.edgeatten"
    fc0 = _dense(sd, f"{ea}.nn_edge.0")  # kernel (2*dim_node+dim_edge, hid)
    k = fc0["kernel"]
    ki = k[:dim_node]
    ke = k[dim_node:dim_node + dim_edge]
    kj = k[dim_node + dim_edge:]
    return {
        "edgeatten_nn_edge_fc0_node_i": {"kernel": ki},
        "edgeatten_nn_edge_fc0_node_j": {"kernel": kj},
        "edgeatten": {
            "nn_edge_fc0_edge": {"kernel": ke, "bias": fc0["bias"]},
            "nn_edge_fc1": _dense(sd, f"{ea}.nn_edge.2"),
            "proj_query": {"fc0": _dense(sd, f"{ea}.proj_query.0")},
            "proj_edge": {"fc0": _dense(sd, f"{ea}.proj_edge.0")},
            "proj_value": {"fc0": _dense(sd, f"{ea}.proj_value.0")},
            "nn": {"conv0": _dense(sd, f"{ea}.nn.0"),
                   "conv1": _dense(sd, f"{ea}.nn.{gate_last}")},
        },
        "prop": {"fc0": _dense(sd, f"{prefix}.prop.0"),
                 "fc1": _dense(sd, f"{prefix}.prop.2")},
    }


def import_dist_mlp(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """self_attn_fc Sequential [Linear0, ReLU, LN2, Linear3, ReLU, LN5,
    Linear6] -> DistanceBiasMLP."""
    return {
        "fc0": _dense(sd, f"{prefix}.0"),
        "ln0": _layernorm(sd, f"{prefix}.2"),
        "fc1": _dense(sd, f"{prefix}.3"),
        "ln1": _layernorm(sd, f"{prefix}.5"),
        "fc2": _dense(sd, f"{prefix}.6"),
    }


def import_mmg(sd: Mapping[str, np.ndarray], depth: int = 2) -> Dict[str, Any]:
    out: Dict[str, Any] = {"self_attn_fc": import_dist_mlp(sd, "self_attn_fc")}
    for i in range(depth):
        out[f"self_attn_{i}"] = import_mha(sd, f"self_attn.{i}")
        out[f"cross_attn_{i}"] = import_mha(sd, f"cross_attn.{i}")
        out[f"cross_attn_rel_{i}"] = import_mha(sd, f"cross_attn_rel.{i}")
        out[f"gcn_3d_{i}"] = import_gean(sd, f"gcn_3ds.{i}")
        out[f"gcn_2d_{i}"] = import_gean(sd, f"gcn_2ds.{i}")
    return out


def import_rel_predictor(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    return {f"fc{i}": _dense(sd, f"fc{i}") for i in (1, 2, 3)}


def import_mmgnet(module_state_dicts: Mapping[str, Mapping[str, np.ndarray]],
                  depth: int = 2) -> Dict[str, Any]:
    """Assemble the flax-shaped variables of ``MMGNet``.

    ``module_state_dicts`` maps reference child-module names (the per-file
    checkpoints of BaseModel.save) to their state dicts.  Returns
    {"params": ..., "batch_stats": ...}.
    """
    sds = module_state_dicts
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    params["obj_encoder"] = import_pointnet(sds["obj_encoder"])
    params["rel_encoder_2d"] = import_pointnet(sds["rel_encoder_2d"])
    params["rel_encoder_3d"] = import_pointnet(sds["rel_encoder_3d"])
    params["mmg"] = import_mmg(sds["mmg"], depth=depth)
    params["clip_adapter"] = import_adapter(sds["clip_adapter"])
    params["rel_predictor_2d"] = import_rel_predictor(sds["rel_predictor_2d"])
    params["rel_predictor_3d"] = import_rel_predictor(sds["rel_predictor_3d"])
    params["obj_predictor_2d"] = _dense(sds["obj_predictor_2d"], "")  # bare Linear
    params["obj_predictor_3d"] = _dense(sds["obj_predictor_3d"], "")

    mlp = sds["mlp_3d"]
    params["mlp_3d_fc"] = _dense(mlp, "0")
    params["mlp_3d_bn"], batch_stats["mlp_3d_bn"] = _batchnorm(mlp, "1")
    tp = sds.get("triplet_projector_2d")
    if tp is not None:
        params["triplet_projector_2d"] = {"fc0": _dense(tp, "0"), "fc1": _dense(tp, "3")}
    if "obj_logit_scale" in sds:
        scale = sds["obj_logit_scale"]
        val = scale.get("obj_logit_scale", next(iter(scale.values())))
        params["obj_logit_scale"] = np.asarray(val, np.float32).reshape(())

    return {"params": params, "batch_stats": batch_stats}


def _batchnorm(sd, prefix) -> Dict[str, Dict[str, np.ndarray]]:
    """torch BatchNorm1d -> (params{scale,bias}, batch_stats{mean,var})."""
    return (
        {"scale": _v(sd[f"{prefix}.weight"]), "bias": _v(sd[f"{prefix}.bias"])},
        {"mean": _v(sd[f"{prefix}.running_mean"]),
         "var": _v(sd[f"{prefix}.running_var"])},
    )


def import_triplet_gcn(sd: Mapping[str, np.ndarray], prefix: str = "") -> Dict[str, Any]:
    """TripletGCN (network_TripletGCN.py:43-71) -> ``TripletGCN`` params.

    nn1 Sequential indices (build_mlp on_last=True): Linear0, BN1, ReLU2,
    Linear3, BN4, ReLU5; nn2 (on_last=False): Linear0, BN1, ReLU2, Linear3.
    Returns {"params": ..., "batch_stats": ...}.
    """
    p = f"{prefix}." if prefix else ""
    params: Dict[str, Any] = {
        "nn1_fc0": _dense(sd, f"{p}nn1.0"),
        "nn1_fc1": _dense(sd, f"{p}nn1.3"),
        "nn2_fc0": _dense(sd, f"{p}nn2.0"),
        "nn2_fc1": _dense(sd, f"{p}nn2.3"),
    }
    stats: Dict[str, Any] = {}
    for name, idx in (("nn1_bn0", "nn1.1"), ("nn1_bn1", "nn1.4"),
                      ("nn2_bn0", "nn2.1")):
        params[name], stats[name] = _batchnorm(sd, f"{p}{idx}")
    return {"params": params, "batch_stats": stats}


def import_mmgnet_single(module_state_dicts: Mapping[str, Mapping[str, np.ndarray]],
                         depth: int = 2) -> Dict[str, Any]:
    """Assemble the flax-shaped variables of ``MMGNetSingle`` from the
    reference model_single per-module checkpoints (model_single.py:46-112)."""
    sds = module_state_dicts
    params: Dict[str, Any] = {
        "obj_encoder": import_pointnet(sds["obj_encoder"]),
        "rel_encoder_3d": import_pointnet(sds["rel_encoder_3d"]),
        "mmg": {f"gcn_3d_{i}": import_gean(sds["mmg"], f"gcn_3ds.{i}")
                for i in range(depth)},
        "rel_predictor_3d": import_rel_predictor(sds["rel_predictor_3d"]),
        "obj_predictor_3d": _dense(sds["obj_predictor_3d"], ""),
    }
    mlp = sds["mlp_3d"]
    params["mlp_3d_fc"] = _dense(mlp, "0")
    batch_stats: Dict[str, Any] = {}
    params["mlp_3d_bn"], batch_stats["mlp_3d_bn"] = _batchnorm(mlp, "1")
    tp = sds.get("triplet_projector_3d")
    if tp is not None:
        params["triplet_projector_3d"] = {"fc0": _dense(tp, "0"), "fc1": _dense(tp, "3")}
    if "obj_logit_scale" in sds:
        scale = sds["obj_logit_scale"]
        val = scale.get("obj_logit_scale", next(iter(scale.values())))
        params["obj_logit_scale"] = np.asarray(val, np.float32).reshape(())
    return {"params": params, "batch_stats": batch_stats}


def import_sgfn(module_state_dicts: Mapping[str, Mapping[str, np.ndarray]],
                depth: int = 2, dim_edge: int = 256) -> Dict[str, Any]:
    """Assemble the flax-shaped variables of ``SGFN`` from the reference
    baseline_sgfn per-module checkpoints (baseline_sgfn.py:43-99)."""
    sds = module_state_dicts
    gcn: Dict[str, Any] = {"self_attn_fc": import_dist_mlp(sds["gcn"], "self_attn_fc")}
    for i in range(depth):
        gcn[f"self_attn_{i}"] = import_mha(sds["gcn"], f"self_attn.{i}")
        gcn[f"gconv_{i}"] = import_gean(sds["gcn"], f"gconvs.{i}", dim_edge=dim_edge)
    params = {
        "obj_encoder": import_pointnet(sds["obj_encoder"]),
        "rel_encoder": import_pointnet(sds["rel_encoder"]),
        "gcn": gcn,
        "obj_predictor": import_rel_predictor(sds["obj_predictor"]),
        "rel_predictor": import_rel_predictor(sds["rel_predictor"]),
    }
    return {"params": params, "batch_stats": {}}


def import_sgpn(module_state_dicts: Mapping[str, Mapping[str, np.ndarray]]
                ) -> Dict[str, Any]:
    """Assemble the flax-shaped variables of ``SGPN`` from the original's
    per-child checkpoints (VL-SAT's src/model/SGFN_MMG/baseline_sgpn.py,
    ``WITH_BN`` false): ``obj_encoder`` and ``rel_encoder`` (PointNetfeat:
    Conv1d ``conv1``-``conv3``, weights (out, in, 1)), ``obj_predictor``
    (PointNetCls) and ``rel_predictor`` (PointNetRelClsMulti), each
    ``fc1``-``fc3``."""
    sds = module_state_dicts
    params = {name: import_pointnet(sds[name]) for name in ("obj_encoder", "rel_encoder")}
    params.update({name: import_rel_predictor(sds[name])
                   for name in ("obj_predictor", "rel_predictor")})
    return {"params": params, "batch_stats": {}}


def _conv(sd, prefix, bias: bool = True) -> Dict[str, np.ndarray]:
    """A 1x1 Conv1d/Conv2d (out, in, 1[, 1]) -> a Dense kernel (in, out)."""
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    out = {"kernel": w.reshape(w.shape[0], -1).T}
    if bias:
        out["bias"] = _v(sd[f"{prefix}.bias"])
    return out


def _bare(sd, prefix) -> Dict[str, np.ndarray]:
    """A Linear without bias."""
    p = f"{prefix}." if prefix else ""
    return {"kernel": _t(sd[f"{p}weight"])}


def import_edgegcn(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """SGGpoint's EdgeGCN (model.py:136-206) -> ``EdgeGCN`` params: each
    torch-geometric GCNConv's ``lin.weight`` and its ``bias`` (added after
    the propagation; the port applies the Dense after it, the same
    function) to ``node_GConv*_fc``, the 1x1 Conv1d of ``edge_MLP1`` /
    ``edge_MLP2`` (``Sequential(Conv1d, ReLU)``) to ``edge_MLP*_fc``."""
    p = f"{prefix}."
    out = {name: _dense(sd, p + name) for name in
           ("edge_attentionND", "node_attentionND", "node_indicator_reduction")}
    for i in (1, 2):
        out[f"node_GConv{i}_fc"] = {"kernel": _t(sd[f"{p}node_GConv{i}.lin.weight"]),
                                    "bias": _v(sd[f"{p}node_GConv{i}.bias"])}
        out[f"edge_MLP{i}_fc"] = _conv(sd, f"{p}edge_MLP{i}.0")
    return out


def import_sggpoint(module_state_dicts: Mapping[str, Mapping[str, np.ndarray]]
                    ) -> Dict[str, Any]:
    """Assemble the flax-shaped variables of ``SGGpoint`` from the
    original's per-child checkpoints (VL-SAT's src/model/SGGpoint/model.py;
    ``benchmark/reference/sggpoint.py`` lays them out): the DGCNN's 1x1
    Conv2d/Conv1d kernels (``backbone.conv{1..5}.0``) and their
    BatchNorm2d/1d (``.1``: weight, bias, running statistics), the Linears,
    the adapter, ``edge_gcn``'s distance MLP, attentions and EdgeGCNs
    (``import_edgegcn``), the cosine classifiers and their
    ``obj_logit_scale``, the EdgeMLP relation heads (``edge_linear1``,
    ``edge_BnReluDp.0``, ``edge_linear2``) and the triplet projectors.
    Returns {"params": ..., "batch_stats": ...}."""
    sds = module_state_dicts
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    bb = sds["backbone"]
    params["backbone"], stats["backbone"] = {}, {}
    for i in range(1, 6):
        params["backbone"][f"conv{i}_fc"] = _conv(bb, f"conv{i}.0", bias=False)
        params["backbone"][f"conv{i}_bn"], stats["backbone"][f"conv{i}_bn"] = _batchnorm(
            bb, f"conv{i}.1")
    for name in ("mlp_3d", "edge_mlp_3d", "edge_mlp_2d", "obj_mlp_3d", "obj_mlp_2d",
                 "rel_mlp_3d", "rel_mlp_2d"):
        params[name] = _dense(sds[name], "")
    params["clip_adapter"] = import_adapter(sds["clip_adapter"])
    gcn = sds["edge_gcn"]
    params["edge_gcn"] = {"self_attn_fc": import_dist_mlp(gcn, "self_attn_fc"),
                          "edgegcn_3d": import_edgegcn(gcn, "edgegcn_3d"),
                          "edgegcn_2d": import_edgegcn(gcn, "edgegcn_2d")}
    for name in ("self_attn", "cross_attn", "cross_attn_rel"):
        params["edge_gcn"][name] = import_mha(gcn, name)
    for branch in ("3d", "2d"):
        params[f"obj_classifier_{branch}"] = _bare(sds[f"obj_classifier_{branch}"], "")
        head = sds[f"rel_classifier_{branch}"]
        bn, bn_stats = _batchnorm(head, "edge_BnReluDp.0")
        params[f"rel_classifier_{branch}"] = {"edge_linear1": _bare(head, "edge_linear1"),
                                              "edge_bn": bn,
                                              "edge_linear2": _bare(head, "edge_linear2")}
        stats[f"rel_classifier_{branch}"] = {"edge_bn": bn_stats}
        tp = sds[f"triplet_projector_{branch}"]
        params[f"triplet_projector_{branch}"] = {"fc0": _dense(tp, "0"), "fc1": _dense(tp, "3")}
    scale = sds["obj_logit_scale"]
    params["obj_logit_scale"] = np.asarray(
        scale.get("obj_logit_scale", next(iter(scale.values()))), np.float32).reshape(())
    return {"params": params, "batch_stats": stats}


def import_from_directory(ckpt_dir: str, suffix: str = ".pth",
                          depth: int = 2) -> Dict[str, Any]:
    """Load a reference experiment checkpoint directory (one file per
    module, BaseModel.save naming) and assemble flax variables."""
    names = [
        "obj_encoder", "rel_encoder_2d", "rel_encoder_3d", "mmg",
        "clip_adapter", "rel_predictor_2d", "rel_predictor_3d",
        "obj_predictor_2d", "obj_predictor_3d", "mlp_3d",
        "triplet_projector_2d", "obj_logit_scale",
    ]
    sds = {}
    for n in names:
        path = os.path.join(ckpt_dir, n + suffix)
        if os.path.exists(path):
            sds[n] = load_state_dict(path)
    return import_mmgnet(sds, depth=depth)


def to_state_dict(variables: Mapping[str, Any], model: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of ``model`` from an ``import_*`` tree; a
    slot the tree does not fill raises."""
    return tree_to_state_dict(variables["params"], variables["batch_stats"], model)


def state_dict_from_directory(ckpt_dir: str, model: nn.Module,
                              suffix: str = ".pth", depth: int = 2
                              ) -> Dict[str, torch.Tensor]:
    """``import_from_directory`` then ``to_state_dict``: a reference
    ``Mmgnet`` checkpoint directory as the port's ``MMGNet`` state_dict."""
    return to_state_dict(import_from_directory(ckpt_dir, suffix=suffix, depth=depth), model)
