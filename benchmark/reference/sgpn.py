"""Plain reference of SGPN, the 3DSSG baseline (Wald et al., "Learning 3D
Semantic Scene Graphs from 3D Indoor Reconstructions", CVPR 2020), as
VL-SAT re-implements it (src/model/SGFN_MMG/baseline_sgpn.py of
wz7in/CVPR2023-VLSAT, ``WITH_BN`` false, with 3DSSG's
network_PointNet.py).

The module holds the source's four children with the source's layouts, so
that ``module_state_dicts`` gives the original checkpoint layout (one state
dict a direct child, as BaseModel.save writes them):

* ``obj_encoder``: ``PointNetfeat`` over an instance's points, Conv1d 1x1
  ``conv1``-``conv3`` (3 -> 64 -> 128 -> 512), ReLU after each, max over
  the points;
* ``rel_encoder``: ``PointNetfeat`` over an edge's union cloud (4 -> 64 ->
  128 -> 256): xyz and the mask channel (1 subject, 2 object, 0 other);
* ``obj_predictor``: ``PointNetCls`` (``fc1`` 512, ``fc2`` 256, dropout
  0.3, ``fc3``), log-softmax over the 160 classes;
* ``rel_predictor``: ``PointNetRelClsMulti`` (the same layers over 256
  wide edge features), a sigmoid over the 26 predicates.

``forward_3d`` runs over a block of unpadded scenes (``plain.flatten``)
and the block's union clouds, stacked in the block's edge order; the
relation encoder takes them ``rows`` at a time, so that a block of large
rooms fits (one row's last layer is 256 x 256 floats).

Departures from the source, each without effect on the outputs in eval
mode: no input or feature transform (the source builds both encoders with
``input_transform=False``, ``feature_transform=False``), no batch norm
(``WITH_BN`` false), dropout off (``eval()``); no ``.cuda()``: every tensor
lives on the input's device.  Everything is float32; the callers switch
TF32 off for matmul and cuDNN (``plain.set_tf32(False)``), and the control
switches it on.  Imports torch and numpy only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

OBJ_WIDTHS = (64, 128, 512)
REL_WIDTHS = (64, 128, 256)


class PointNetfeat(nn.Module):
    """x (M, C, P) -> (M, out): three 1x1 convolutions, ReLU after each, max
    over the points."""

    def __init__(self, point_size: int, widths=OBJ_WIDTHS):
        super().__init__()
        self.conv1 = nn.Conv1d(point_size, widths[0], 1)
        self.conv2 = nn.Conv1d(widths[0], widths[1], 1)
        self.conv3 = nn.Conv1d(widths[1], widths[2], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        return torch.max(x, 2)[0]


class PointNetCls(nn.Module):
    """fc1-relu / fc2-dropout-relu / fc3, log-softmax."""

    def __init__(self, k: int, in_size: int):
        super().__init__()
        self.fc1 = nn.Linear(in_size, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)
        self.dropout = nn.Dropout(p=0.3)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(x))
        x = F.relu(self.dropout(self.fc2(x)))
        return self.fc3(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.logits(x), dim=1)


class PointNetRelClsMulti(PointNetCls):
    """``PointNetCls``' layers with a sigmoid: multi-label predicates."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.logits(x))


class SGPNReference(nn.Module):
    def __init__(self, num_obj: int = 160, num_rel: int = 26, point_size: int = 3):
        super().__init__()
        self.obj_encoder = PointNetfeat(point_size, OBJ_WIDTHS)
        self.rel_encoder = PointNetfeat(point_size + 1, REL_WIDTHS)
        self.obj_predictor = PointNetCls(num_obj, OBJ_WIDTHS[-1])
        self.rel_predictor = PointNetRelClsMulti(num_rel, REL_WIDTHS[-1])

    def forward_3d(self, blk: Dict[str, torch.Tensor], union: torch.Tensor,
                   rows: int = 2048) -> Dict[str, torch.Tensor]:
        """Object log-probabilities (n, C) and predicate probabilities (e, R)
        of the block's nodes and edges; ``union`` (e, Pu, C + 1) holds the
        block's union clouds in its edge order, on any device and in any
        float type (each block of ``rows`` goes to the block's device and
        float type)."""
        pts = blk["obj_points"]
        obj = self.obj_predictor(self.obj_encoder(pts.transpose(1, 2)))
        feats = [self.rel_encoder(union[lo:lo + rows].to(pts.device, pts.dtype).transpose(1, 2))
                 for lo in range(0, len(union), rows)]
        return {"obj_logits_3d": obj, "rel_cls_3d": self.rel_predictor(torch.cat(feats))}


def module_state_dicts(ref: SGPNReference) -> Dict[str, Dict[str, np.ndarray]]:
    """The reference's weights in the original checkpoint layout: one state
    dict of host arrays a direct child."""
    return {name: {k: v.detach().cpu().numpy() for k, v in child.state_dict().items()}
            for name, child in ref.named_children()}
