"""The flagship VL-SAT model (counterpart of
``vlsat_tpu/models/mmgnet.py:46-95,114-291``).

  obj_points --PointNet(3->768)--> mlp_3d(768->504) ++ spatial(8) -> (N, 512)
  descriptor --edge_descriptor--> rel_encoder_{3d,2d} (11->512)
  obj_2d_feats --clip_adapter (detached)--> (N, 512)
  MMG dual-branch stack -> rel_predictor_{3d,2d}: 512->512->256->26 sigmoid
                        -> obj_logits_{3d,2d} = exp(obj_logit_scale) * cosine classifier

``branch_3d_only=True`` (the serving protocol) skips every 2D module; the 3D
outputs are the same.  In eval mode it can run its per-edge layers on the
batch's computed edge rows alone (``edge_rows``), packed across scenes.
``istrain=True`` adds the train-time outputs of the distillation losses (the
mimic features, ``triplet_projector_2d``'s projected 2D pair features and
``logit_scale``).  The module's mode decides
dropout, BatchNorm statistics and the kernel routes, as JAX's
``deterministic`` does: ``model.eval()`` with ``istrain=True`` is JAX's
``istrain=True, deterministic=True``.  The config switches of the in21k
model (``cosine_classifier``, ``use_adapter``, ``use_mlp_3d``) and
``use_spatial`` drop the modules they name, as in JAX (mmgnet.py:179-191,
213-223, 250-268).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.models.layers import (AdapterModel, Dropout, MaskedBatchNorm,
                                           PointNetEncoder)
from vlsat_tpu_torch.models.mmg import MMG
from vlsat_tpu_torch.models.transformer import FLAX_LN_EPS, set_layer_norm_eps
from vlsat_tpu_torch.ops.descriptor import edge_descriptor
from vlsat_tpu_torch.ops.graph import EdgeRows, gather_edge_endpoints, unpack_edges
from vlsat_tpu_torch.ops.norm import safe_normalize
from vlsat_tpu_torch.scene import SceneBatch


@dataclasses.dataclass(frozen=True)
class MMGNetConfig:
    """The fields of ``vlsat_tpu.models.MMGNetConfig`` that the forward
    reads, with the same defaults, plus ``point_channels`` (flax infers the
    encoder's input width from the data; torch layers need it up front).
    The in21k switches: ``cosine_classifier=False`` makes the object heads
    plain Linears with ``logit_scale`` 1, ``use_adapter=False`` feeds
    ``obj_2d_feats`` to the 2D branch as they are, ``use_mlp_3d=False``
    drops the point_feature_size -> dim_node - 8 bottleneck.  ``ln_eps``: the
    LayerNorms' epsilon (flax's by default; the registry builds the
    original's, ``models.transformer``)."""

    num_obj_classes: int = 160
    num_rel_classes: int = 26
    point_feature_size: int = 768
    dim_node: int = 512
    dim_edge: int = 512
    dim_atten: int = 256
    num_heads: int = 8
    depth: int = 2
    gcn_aggr: str = "max"
    dropout_atten: float = 0.5
    use_gcn_edge: bool = True
    clip_feat_dim: int = 512
    adapter_alpha: float = 0.5
    multi_rel_outputs: bool = True
    fused_pointnet: bool = False  # fused PointNet kernel for the object encoder
    point_channels: int = 3
    use_spatial: bool = True
    cosine_classifier: bool = True
    use_adapter: bool = True
    use_mlp_3d: bool = True
    ln_eps: float = FLAX_LN_EPS


class RelPredictor(nn.Module):
    """Relation head: fc1-relu / fc2-dropout-relu / fc3, then sigmoid
    (multi-label) or log-softmax (mmgnet.py:78-94)."""

    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.3,
                 multi_label: bool = True):
        super().__init__()
        self.multi_label = multi_label
        self.fc1 = nn.Linear(in_features, 512)
        self.fc2 = nn.Linear(512, 256)
        self.drop = Dropout(dropout)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(self, x, rng=None):
        x = torch.relu(self.drop(self.fc2(torch.relu(self.fc1(x))), rng))
        x = self.fc3(x)
        return torch.sigmoid(x) if self.multi_label else torch.log_softmax(x, dim=-1)


class RelPredictorMulti2(nn.Module):
    """Alternate multi-label head (mmgnet.py:97-111): fc1(256)-relu /
    fc2(512)-dropout-relu / L2-normalise / fc3, then sigmoid."""

    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.3):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 256)
        self.fc2 = nn.Linear(256, 512)
        self.drop = Dropout(dropout)
        self.fc3 = nn.Linear(512, num_classes)

    def forward(self, x, rng=None):
        x = torch.relu(self.drop(self.fc2(torch.relu(self.fc1(x))), rng))
        return torch.sigmoid(self.fc3(safe_normalize(x)))


def spatial_features(descriptor: torch.Tensor) -> torch.Tensor:
    """The 8 spatial features appended to the object features: the
    descriptor's std and bbox columns as they are, log of its volume and
    length (mmgnet.py:186-191)."""
    spatial = descriptor[..., 3:]
    return torch.cat([spatial[..., :6], torch.log(spatial[..., 6:])], dim=-1)


class TripletProjector(nn.Module):
    """Linear(in -> 1024) - Dropout(0.5) - ReLU - Linear(1024 -> 512)
    (mmgnet.py:114-122): the 2D pair features pulled toward CLIP text."""

    def __init__(self, in_features: int):
        super().__init__()
        self.fc0 = nn.Linear(in_features, 1024)
        self.drop = Dropout(0.5)
        self.fc1 = nn.Linear(1024, 512)

    def forward(self, x, rng=None):
        return self.fc1(torch.relu(self.drop(self.fc0(x), rng)))


class MMGNet(nn.Module):
    """Flagship dual-branch model.  Apply to a SceneBatch of f32 tensors.

    ``obj_text_features``: optional (num_obj_classes, dim_node) table of
    normalised CLIP text embeddings that ``init_parameters`` copies into the
    cosine classifiers named in ``text_classifiers`` (``_text_kernel_init``,
    mmgnet.py:125-141).  A config whose node features are not ``dim_node``
    wide (``use_spatial=False`` with ``use_mlp_3d``) raises: the attention's
    residual cannot add them, and the JAX model fails on it too."""

    def __init__(self, cfg: MMGNetConfig = MMGNetConfig(),
                 obj_text_features: Optional[np.ndarray] = None):
        super().__init__()
        width = ((cfg.dim_node - 8 if cfg.use_mlp_3d else cfg.point_feature_size)
                 + 8 * cfg.use_spatial)
        if width != cfg.dim_node:
            raise ValueError(f"the node features are {width} wide, not dim_node "
                             f"{cfg.dim_node} (use_spatial={cfg.use_spatial}, "
                             f"use_mlp_3d={cfg.use_mlp_3d})")
        self.cfg = cfg
        self.obj_text_features = obj_text_features
        self.text_classifiers = (("obj_predictor_3d", "obj_predictor_2d")
                                 if cfg.cosine_classifier else ())
        self.obj_encoder = PointNetEncoder(cfg.point_channels, cfg.point_feature_size,
                                           fused=cfg.fused_pointnet)
        if cfg.use_mlp_3d:
            self.mlp_3d_fc = nn.Linear(cfg.point_feature_size, cfg.dim_node - 8)
            self.mlp_3d_bn = MaskedBatchNorm(cfg.dim_node - 8)
            self.mlp_3d_drop = Dropout(0.1)
        self.rel_encoder_2d = PointNetEncoder(11, cfg.dim_edge)
        self.rel_encoder_3d = PointNetEncoder(11, cfg.dim_edge)
        if cfg.use_adapter:
            self.clip_adapter = AdapterModel(cfg.clip_feat_dim, alpha=cfg.adapter_alpha)
        self.mmg = MMG(dim_node=cfg.dim_node, dim_edge=cfg.dim_edge,
                       dim_atten=cfg.dim_atten, num_heads=cfg.num_heads,
                       depth=cfg.depth, aggr=cfg.gcn_aggr,
                       dropout_atten=cfg.dropout_atten, use_edge=cfg.use_gcn_edge)
        rel_head = lambda: RelPredictor(cfg.dim_edge, cfg.num_rel_classes,
                                        multi_label=cfg.multi_rel_outputs)
        self.rel_predictor_3d = rel_head()
        self.rel_predictor_2d = rel_head()
        if cfg.cosine_classifier:
            self.obj_logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.obj_predictor_3d = nn.Linear(cfg.dim_node, cfg.num_obj_classes)
        self.obj_predictor_2d = nn.Linear(cfg.dim_node, cfg.num_obj_classes)
        self.triplet_projector_2d = TripletProjector(2 * cfg.dim_node + cfg.dim_edge)
        set_layer_norm_eps(self, cfg.ln_eps)

    def forward(self, batch: SceneBatch, istrain: bool = False,
                branch_3d_only: bool = False, rng: Optional[torch.Generator] = None,
                edge_rows: Optional[EdgeRows] = None) -> Dict[str, torch.Tensor]:
        """``rng`` draws every dropout mask in training mode (a generator on
        the batch's device).  ``edge_rows`` (``ops.graph.EdgeRows``, on the
        batch's device; the 3D-only eval forward) runs every per-edge stage
        (descriptor, relation encoder, the GCN layers' edge side, relation
        head) on the packed rows it names instead of the whole (B, E) grid;
        ``rel_cls_3d`` is the same dense (B, E, R) tensor."""
        if istrain and branch_3d_only:
            raise ValueError("branch_3d_only is an inference mode")
        if edge_rows is not None and not (branch_3d_only and not self.training):
            raise ValueError("edge_rows is for the 3D-only forward in eval mode")
        with_2d = not branch_3d_only
        cfg = self.cfg
        obj = self.obj_encoder(batch.obj_points)
        obj_feature_3d_mimic = obj[..., :cfg.clip_feat_dim]
        if cfg.use_mlp_3d:
            obj = self.mlp_3d_fc(obj)
            obj = self.mlp_3d_drop(torch.relu(self.mlp_3d_bn(obj, batch.obj_mask)), rng)
        if cfg.use_spatial:
            obj = torch.cat([obj, spatial_features(batch.descriptor)], dim=-1)

        if edge_rows is None:
            edge_feat = edge_descriptor(batch.descriptor, batch.edge_index).detach()
        else:  # the packed rows over the flat node table, as one scene
            edge_feat = edge_descriptor(batch.descriptor.flatten(0, 1)[None],
                                        edge_rows.ends[None])[0]
        rel_2d = self.rel_encoder_2d(edge_feat[..., None, :]) if with_2d else None
        rel_3d = self.rel_encoder_3d(edge_feat[..., None, :])
        obj_2d = None
        if with_2d:
            obj_2d = (self.clip_adapter(batch.obj_2d_feats).detach() if cfg.use_adapter
                      else batch.obj_2d_feats)

        f3d, f2d, e3d, e2d = self.mmg(obj, obj_2d, rel_3d, rel_2d, batch.edge_index,
                                      batch.obj_mask, batch.edge_mask,
                                      batch.descriptor[..., :3], with_2d=with_2d, rng=rng,
                                      edge_rows=edge_rows)
        rel_cls_3d = self.rel_predictor_3d(e3d, rng)
        if edge_rows is not None:
            rel_cls_3d = unpack_edges(rel_cls_3d, edge_rows.src, batch.num_scenes)
        if cfg.cosine_classifier:
            scale = torch.exp(self.obj_logit_scale)
            head = lambda fc, x: scale * fc(safe_normalize(x))
        else:
            scale = f3d.new_ones(())
            head = lambda fc, x: fc(x)
        out = {"obj_logits_3d": head(self.obj_predictor_3d, f3d),
               "rel_cls_3d": rel_cls_3d}
        if with_2d:
            out["obj_logits_2d"] = head(self.obj_predictor_2d, f2d)
            out["rel_cls_2d"] = self.rel_predictor_2d(e2d, rng)
        if istrain:
            f2d_i, f2d_j = gather_edge_endpoints(f2d, batch.edge_index)
            out.update(
                obj_feature_3d_mimic=obj_feature_3d_mimic,
                obj_features_2d_mimic=obj_2d,
                edge_feature_2d_dis=self.triplet_projector_2d(
                    torch.cat([f2d_i, f2d_j, e2d], dim=-1), rng),
                logit_scale=scale)
        return out


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation in place, for every model of the registry:
    LeCun-normal kernels (flax's Dense default), zero biases, unit norm
    scales, identity BN statistics and every ``*logit_scale`` at
    ``log(1/0.07)``; the weights of the cosine classifiers that the model
    names in ``text_classifiers`` are its ``obj_text_features`` table where
    it has one.  Values are drawn on the CPU from ``generator`` and copied
    to the model's device."""
    table = getattr(model, "obj_text_features", None)
    text_weights = {f"{m}.weight" for m in getattr(model, "text_classifiers", ())}
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if table is not None and name in text_weights:
                val = torch.as_tensor(np.asarray(table, np.float32))
                if val.shape != p.shape:
                    raise ValueError(f"obj_text_features {tuple(val.shape)} != {tuple(p.shape)}")
            elif leaf.endswith("logit_scale"):
                val = torch.tensor(math.log(1 / 0.07))
            elif leaf == "kernel":                       # ChannelDense (C, F)
                val = torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[0])
            elif leaf == "weight" and p.dim() == 2:      # Linear (out, in)
                val = torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[1])
            elif leaf == "weight":                       # LayerNorm / BatchNorm
                val = torch.ones(p.shape)
            else:
                val = torch.zeros(p.shape)
            p.copy_(val)
        for name, buf in model.named_buffers():
            buf.fill_(1.0 if name.endswith("running_var") else 0.0)


def build_mmgnet(cfg: MMGNetConfig = MMGNetConfig(), device=None, seed: int = 0,
                 obj_text_features: Optional[np.ndarray] = None) -> MMGNet:
    """Model factory: an eval-mode ``MMGNet`` on ``device`` (the card unless
    the caller passes ``device="cpu"``) with weights drawn from
    ``torch.Generator().manual_seed(seed)`` (and the cosine classifiers
    from ``obj_text_features`` where given)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MMGNet(cfg, obj_text_features)
    model = model.to_empty(device=dev)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
