"""Model registry: config NAME -> (model, train loss) (counterpart of
``vlsat_tpu/models/registry.py``).

Every entry of the JAX registry is built, with the same config fields,
loss partials and in21k widths.  ``fused_pointnet`` stays off in every
entry, as in JAX.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig
from vlsat_tpu_torch.models.mmteacher import MMTeacher, mmteacher_loss
from vlsat_tpu_torch.models.sggpoint import (SGGpoint, SGGpointBaseline, SGGpointConfig,
                                             sggpoint_baseline_loss, sggpoint_loss)
from vlsat_tpu_torch.models.variants import SGFN, SGPN, MMGNetSingle, SGFNConfig, SGPNConfig
from vlsat_tpu_torch.train import losses

_NN_EDGE_MODES = ("edge", "gather", "onehot")


def model_config(name: str, num_obj: int, num_rel: int, mcfg):
    """The config dataclass of registry entry ``name`` for a config's MODEL
    section (attribute access), field for field as the JAX registry fills
    it.

    The encoders' input width ``point_channels`` follows ``USE_RGB`` /
    ``USE_NORMAL`` (3, plus 3 for each), as the dataset appends those
    channels; flax infers it from the batch.

    ``nn_edge_mode``: the JAX package's placements of the first nn_edge
    layer's node projections (vlsat_tpu/models/gnn.py:146-159): "edge"
    projects the gathered endpoints, "gather" projects per node and
    gathers, "onehot" gathers with a one-hot matmul (a TPU layout trick,
    not ported).  The three compute the same function, so the port
    computes all three with its one formulation; any other value raises."""
    mode = mcfg.get("nn_edge_mode", "edge")
    if mode not in _NN_EDGE_MODES:
        raise ValueError(f"unknown nn_edge_mode {mode!r}")
    channels = (3 + 3 * bool(mcfg.get("USE_RGB", False))
                + 3 * bool(mcfg.get("USE_NORMAL", False)))
    gnn = dict(dim_atten=mcfg.DIM_ATTEN, num_heads=mcfg.NUM_HEADS, depth=mcfg.N_LAYERS,
               gcn_aggr=mcfg.GCN_AGGR, dropout_atten=mcfg.DROP_OUT_ATTEN,
               use_gcn_edge=mcfg.USE_GCN_EDGE, use_spatial=mcfg.USE_SPATIAL)
    common = dict(num_obj_classes=num_obj, num_rel_classes=num_rel,
                  multi_rel_outputs=mcfg.multi_rel_outputs, point_channels=channels)
    if name in ("Mmgnet", "MmgnetSingle"):
        return MMGNetConfig(**common, **gnn, point_feature_size=mcfg.point_feature_size,
                            clip_feat_dim=mcfg.clip_feat_dim,
                            adapter_alpha=mcfg.adapter_alpha)
    if name == "MMteacher":
        return MMGNetConfig(**common, **gnn)
    if name == "MmgnetIn21k":
        # 768-d ImageNet-21k features, no adapter, plain classifiers
        # (reference model_in21k.py:45,76,144-156,295-296)
        return MMGNetConfig(**common, **gnn, point_feature_size=760, dim_node=768,
                            dim_edge=768, clip_feat_dim=768, cosine_classifier=False,
                            use_adapter=False, use_mlp_3d=False)
    if name == "SGFN":
        gnn["edge_feature_size"] = mcfg.get("edge_feature_size", 256)
        return SGFNConfig(**common, **gnn)
    if name == "SGPN":
        return SGPNConfig(**common, edge_feature_size=mcfg.get("edge_feature_size", 256))
    if name == "SGGpoint":
        if mcfg.clip_feat_dim != SGGpointConfig.dim:
            # JAX takes the width from the batch and fails in the attention
            raise ValueError(f"SGGpoint's 2D features are clip_feat_dim={mcfg.clip_feat_dim} "
                             f"wide, not dim {SGGpointConfig.dim}: the attention residuals "
                             "cannot add them")
        return SGGpointConfig(num_obj_classes=num_obj, num_rel_classes=num_rel,
                              num_heads=mcfg.NUM_HEADS, use_spatial=mcfg.USE_SPATIAL,
                              point_channels=channels)
    if name == "SGGpointBaseline":
        return SGGpointConfig(num_obj_classes=num_obj, num_rel_classes=num_rel,
                              point_channels=channels)
    raise ValueError(f"unknown model NAME {name!r}")


def needs_union_points(name: str) -> bool:
    """Whether registry entry ``name`` reads the per-edge union point clouds
    (``rel_points``), so that its dataset must build them."""
    return name == "SGPN"


def build_model(name: str, num_obj: int, num_rel: int, mcfg,
                obj_text_features: Optional[np.ndarray] = None):
    """Returns ``(model, loss)``: the model of ``model_config`` on the CPU
    with torch's default initialisation (``train.state.create_train_state(...,
    seed=...)`` draws the seeded weights), and the JAX registry's loss,
    bound as it binds it.  ``Mmgnet`` and ``SGGpoint`` with
    ``USE_SPATIAL=false`` raise (both refuse node features narrower than
    their attention width; the JAX models fail on them too)."""
    cfg = model_config(name, num_obj, num_rel, mcfg)
    multi = mcfg.multi_rel_outputs
    if name == "Mmgnet":
        return (MMGNet(cfg, obj_text_features=obj_text_features),
                partial(losses.vlsat_total_loss, multi_rel=multi))
    if name == "MmgnetSingle":
        return (MMGNetSingle(cfg, obj_text_features=obj_text_features),
                partial(losses.vlsat_single_loss, multi_rel=multi))
    if name == "MMteacher":
        return MMTeacher(cfg, obj_text_features=obj_text_features), mmteacher_loss
    if name == "MmgnetIn21k":
        # in21k drops the mimic terms from the total (model_in21k.py:368-375)
        return MMGNet(cfg), partial(losses.vlsat_total_loss, multi_rel=multi,
                                    with_mimic=False)
    if name == "SGFN":
        return SGFN(cfg), partial(losses.sgfn_loss, multi_rel=multi)
    if name == "SGPN":
        return SGPN(cfg), losses.sgpn_loss
    if name == "SGGpoint":
        return SGGpoint(cfg, obj_text_features=obj_text_features), sggpoint_loss
    return SGGpointBaseline(cfg), sggpoint_baseline_loss
