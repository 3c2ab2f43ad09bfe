"""Model registry: config NAME -> (model, train loss) (counterpart of
``vlsat_tpu/models/registry.py``).

The port builds the flagship ``Mmgnet`` entry, paired with
``vlsat_total_loss``; every other model of the JAX registry raises until the
variants are ported (ROADMAP.md, queue 1 item 4).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig
from vlsat_tpu_torch.train import losses

# the JAX registry's other entries
_NOT_PORTED = ("MmgnetSingle", "SGFN", "SGPN", "MMteacher", "MmgnetIn21k", "SGGpoint",
               "SGGpointBaseline")
_NN_EDGE_MODES = ("edge", "gather", "onehot")


def mmgnet_config(num_obj: int, num_rel: int, mcfg) -> MMGNetConfig:
    """The ``MMGNetConfig`` of the ``Mmgnet`` entry for a config's MODEL
    section (attribute access).

    The object encoder's input width follows ``USE_RGB`` / ``USE_NORMAL``
    (3, plus 3 for each), as the dataset appends those channels; flax infers
    it from the batch.  ``USE_SPATIAL=false`` raises: the port's forward
    always appends the descriptor's spatial features, and the switch changes
    layer widths, so it comes with the variants.  ``fused_pointnet`` stays
    off, as in the JAX registry.

    ``nn_edge_mode``: the JAX package's placements of the first nn_edge
    layer's node projections (vlsat_tpu/models/gnn.py:146-159): "edge"
    projects the gathered endpoints, "gather" projects per node and
    gathers, "onehot" gathers with a one-hot matmul (a TPU layout trick,
    not ported).  The three compute the same function, so the port
    computes all three with its one formulation; any other value raises."""
    if not mcfg.USE_SPATIAL:
        raise NotImplementedError(
            "USE_SPATIAL=false is not ported yet (ROADMAP.md, queue 1 item 4)")
    mode = mcfg.get("nn_edge_mode", "edge")
    if mode not in _NN_EDGE_MODES:
        raise ValueError(f"unknown nn_edge_mode {mode!r}")
    return MMGNetConfig(
        num_obj_classes=num_obj, num_rel_classes=num_rel,
        point_feature_size=mcfg.point_feature_size,
        dim_atten=mcfg.DIM_ATTEN, num_heads=mcfg.NUM_HEADS,
        depth=mcfg.N_LAYERS, gcn_aggr=mcfg.GCN_AGGR,
        dropout_atten=mcfg.DROP_OUT_ATTEN, use_gcn_edge=mcfg.USE_GCN_EDGE,
        clip_feat_dim=mcfg.clip_feat_dim, adapter_alpha=mcfg.adapter_alpha,
        multi_rel_outputs=mcfg.multi_rel_outputs,
        point_channels=3 + 3 * bool(mcfg.get("USE_RGB", False))
        + 3 * bool(mcfg.get("USE_NORMAL", False)),
    )


def build_model(name: str, num_obj: int, num_rel: int, mcfg,
                obj_text_features: Optional[np.ndarray] = None):
    """Returns ``(model, loss)``: an ``MMGNet`` of ``mmgnet_config`` on the
    CPU with torch's default initialisation
    (``train.state.create_train_state(..., seed=...)`` draws the seeded
    weights), and ``vlsat_total_loss`` bound to the config's
    ``multi_rel_outputs``."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, queue 1 item 4); "
            "the port builds 'Mmgnet'")
    if name != "Mmgnet":
        raise ValueError(f"unknown model NAME {name!r}")
    loss = partial(losses.vlsat_total_loss, multi_rel=mcfg.multi_rel_outputs)
    return MMGNet(mmgnet_config(num_obj, num_rel, mcfg),
                  obj_text_features=obj_text_features), loss
