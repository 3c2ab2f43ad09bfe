"""The flagship VL-SAT model, 3D-only forward (counterpart of
``vlsat_tpu/models/mmgnet.py:46-95,144-270`` with ``branch_3d_only=True``).

  obj_points --PointNet(3->768)--> mlp_3d(768->504) ++ spatial(8) -> (N, 512)
  descriptor --edge_descriptor--> rel_encoder_3d (11->512)
  MMG 3D stack -> rel_predictor_3d: 512->512->256->26 sigmoid
               -> obj_logits_3d = exp(obj_logit_scale) * cosine classifier

The dual-branch forward (2D encoders, adapter, cross-attentions) and the
train-time extras come with later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.models.layers import MaskedBatchNorm, PointNetEncoder
from vlsat_tpu_torch.models.mmg import MMG
from vlsat_tpu_torch.ops.descriptor import edge_descriptor
from vlsat_tpu_torch.ops.norm import safe_normalize
from vlsat_tpu_torch.scene import SceneBatch


@dataclasses.dataclass(frozen=True)
class MMGNetConfig:
    """The fields of ``vlsat_tpu.models.MMGNetConfig`` that the 3D forward
    reads, with the same defaults, plus ``point_channels`` (flax infers the
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
    """Flagship model, 3D branch.  Apply to a SceneBatch of f32 tensors."""

    def __init__(self, cfg: MMGNetConfig = MMGNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.obj_encoder = PointNetEncoder(cfg.point_channels, cfg.point_feature_size,
                                           fused=cfg.fused_pointnet)
        self.mlp_3d_fc = nn.Linear(cfg.point_feature_size, cfg.dim_node - 8)
        self.mlp_3d_bn = MaskedBatchNorm(cfg.dim_node - 8)
        self.mlp_3d_drop = nn.Dropout(0.1)
        self.rel_encoder_3d = PointNetEncoder(11, cfg.dim_edge)
        self.mmg = MMG(dim_node=cfg.dim_node, dim_edge=cfg.dim_edge,
                       dim_atten=cfg.dim_atten, num_heads=cfg.num_heads,
                       depth=cfg.depth, aggr=cfg.gcn_aggr,
                       dropout_atten=cfg.dropout_atten, use_edge=cfg.use_gcn_edge)
        self.rel_predictor_3d = RelPredictor(cfg.dim_edge, cfg.num_rel_classes,
                                             multi_label=cfg.multi_rel_outputs)
        self.obj_logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.obj_predictor_3d = nn.Linear(cfg.dim_node, cfg.num_obj_classes)

    def forward(self, batch: SceneBatch, branch_3d_only: bool = True
                ) -> Dict[str, torch.Tensor]:
        if not branch_3d_only:
            raise NotImplementedError("only the 3D-only forward is ported")
        obj = self.obj_encoder(batch.obj_points)
        obj = self.mlp_3d_fc(obj)
        obj = self.mlp_3d_drop(torch.relu(self.mlp_3d_bn(obj)))
        spatial = batch.descriptor[..., 3:]
        spatial = torch.cat([spatial[..., :6], torch.log(spatial[..., 6:])], dim=-1)
        obj = torch.cat([obj, spatial], dim=-1)

        edge_feat = edge_descriptor(batch.descriptor, batch.edge_index).detach()
        rel = self.rel_encoder_3d(edge_feat[..., None, :])

        f3d, e3d = self.mmg(obj, rel, batch.edge_index, batch.obj_mask,
                            batch.edge_mask, batch.descriptor[..., :3])
        rel_cls = self.rel_predictor_3d(e3d)
        obj_logits = torch.exp(self.obj_logit_scale) * self.obj_predictor_3d(
            safe_normalize(f3d))
        return {"obj_logits_3d": obj_logits, "rel_cls_3d": rel_cls}


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
