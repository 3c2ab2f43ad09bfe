"""The flagship VL-SAT model, inference forward (counterpart of
``vlsat_tpu/models/mmgnet.py:46-95,144-278``).

  obj_points --PointNet(3->768)--> mlp_3d(768->504) ++ spatial(8) -> (N, 512)
  descriptor --edge_descriptor--> rel_encoder_{3d,2d} (11->512)
  obj_2d_feats --clip_adapter (detached)--> (N, 512)
  MMG dual-branch stack -> rel_predictor_{3d,2d}: 512->512->256->26 sigmoid
                        -> obj_logits_{3d,2d} = exp(obj_logit_scale) * cosine classifier

``branch_3d_only=True`` (the serving protocol) skips every 2D module; the 3D
outputs are the same.  The train-time extras (``triplet_projector_2d``, the
mimic features) and the in21k switches (``cosine_classifier``,
``use_adapter``, ``use_mlp_3d``) come with the training and variants slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.models.layers import AdapterModel, MaskedBatchNorm, PointNetEncoder
from vlsat_tpu_torch.models.mmg import MMG
from vlsat_tpu_torch.ops.descriptor import edge_descriptor
from vlsat_tpu_torch.ops.norm import safe_normalize
from vlsat_tpu_torch.scene import SceneBatch


@dataclasses.dataclass(frozen=True)
class MMGNetConfig:
    """The fields of ``vlsat_tpu.models.MMGNetConfig`` that the inference
    forward reads, with the same defaults, plus ``point_channels`` (flax infers the
    encoder's input width from the data; torch layers need it up front)."""

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


class RelPredictor(nn.Module):
    """Relation head: fc1-relu / fc2-dropout-relu / fc3, then sigmoid
    (multi-label) or log-softmax (mmgnet.py:78-94)."""

    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.3,
                 multi_label: bool = True):
        super().__init__()
        self.multi_label = multi_label
        self.fc1 = nn.Linear(in_features, 512)
        self.fc2 = nn.Linear(512, 256)
        self.drop = nn.Dropout(dropout)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(self, x):
        x = torch.relu(self.drop(self.fc2(torch.relu(self.fc1(x)))))
        x = self.fc3(x)
        return torch.sigmoid(x) if self.multi_label else torch.log_softmax(x, dim=-1)


class MMGNet(nn.Module):
    """Flagship dual-branch model.  Apply to a SceneBatch of f32 tensors."""

    def __init__(self, cfg: MMGNetConfig = MMGNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.obj_encoder = PointNetEncoder(cfg.point_channels, cfg.point_feature_size,
                                           fused=cfg.fused_pointnet)
        self.mlp_3d_fc = nn.Linear(cfg.point_feature_size, cfg.dim_node - 8)
        self.mlp_3d_bn = MaskedBatchNorm(cfg.dim_node - 8)
        self.mlp_3d_drop = nn.Dropout(0.1)
        self.rel_encoder_2d = PointNetEncoder(11, cfg.dim_edge)
        self.rel_encoder_3d = PointNetEncoder(11, cfg.dim_edge)
        self.clip_adapter = AdapterModel(cfg.clip_feat_dim, alpha=cfg.adapter_alpha)
        self.mmg = MMG(dim_node=cfg.dim_node, dim_edge=cfg.dim_edge,
                       dim_atten=cfg.dim_atten, num_heads=cfg.num_heads,
                       depth=cfg.depth, aggr=cfg.gcn_aggr,
                       dropout_atten=cfg.dropout_atten, use_edge=cfg.use_gcn_edge)
        rel_head = lambda: RelPredictor(cfg.dim_edge, cfg.num_rel_classes,
                                        multi_label=cfg.multi_rel_outputs)
        self.rel_predictor_3d = rel_head()
        self.rel_predictor_2d = rel_head()
        self.obj_logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.obj_predictor_3d = nn.Linear(cfg.dim_node, cfg.num_obj_classes)
        self.obj_predictor_2d = nn.Linear(cfg.dim_node, cfg.num_obj_classes)

    def forward(self, batch: SceneBatch, branch_3d_only: bool = False
                ) -> Dict[str, torch.Tensor]:
        with_2d = not branch_3d_only
        obj = self.obj_encoder(batch.obj_points)
        obj = self.mlp_3d_fc(obj)
        obj = self.mlp_3d_drop(torch.relu(self.mlp_3d_bn(obj)))
        spatial = batch.descriptor[..., 3:]
        spatial = torch.cat([spatial[..., :6], torch.log(spatial[..., 6:])], dim=-1)
        obj = torch.cat([obj, spatial], dim=-1)

        edge_feat = edge_descriptor(batch.descriptor, batch.edge_index).detach()
        rel_2d = self.rel_encoder_2d(edge_feat[..., None, :]) if with_2d else None
        rel_3d = self.rel_encoder_3d(edge_feat[..., None, :])
        obj_2d = self.clip_adapter(batch.obj_2d_feats).detach() if with_2d else None

        f3d, f2d, e3d, e2d = self.mmg(obj, obj_2d, rel_3d, rel_2d, batch.edge_index,
                                      batch.obj_mask, batch.edge_mask,
                                      batch.descriptor[..., :3], with_2d=with_2d)
        scale = torch.exp(self.obj_logit_scale)
        out = {"obj_logits_3d": scale * self.obj_predictor_3d(safe_normalize(f3d)),
               "rel_cls_3d": self.rel_predictor_3d(e3d)}
        if with_2d:
            out["obj_logits_2d"] = scale * self.obj_predictor_2d(safe_normalize(f2d))
            out["rel_cls_2d"] = self.rel_predictor_2d(e2d)
        return out


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation in place: LeCun-normal kernels (flax's Dense
    default), zero biases, unit norm scales, identity BN statistics and
    ``obj_logit_scale = log(1/0.07)``.  Values are drawn on the CPU from
    ``generator`` and copied to the model's device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "obj_logit_scale":
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


def build_mmgnet(cfg: MMGNetConfig = MMGNetConfig(), device=None, seed: int = 0) -> MMGNet:
    """Model factory: an eval-mode ``MMGNet`` on ``device`` (the card unless
    the caller passes ``device="cpu"``) with weights drawn from
    ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MMGNet(cfg)
    model = model.to_empty(device=dev)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
