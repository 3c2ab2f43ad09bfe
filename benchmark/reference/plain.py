"""Plain forward, loss and optimizer of the reference, over unpadded scenes.

The scenes of a block are concatenated, as the original reference batches
them: nodes stacked with ``batch_ids``, edges stacked with their node
indices offset, no padding and no masks.  Everything is fp32; the callers
switch TF32 off (``fp32``), and the control switches it on.  Imports torch
and numpy only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def flatten(scenes: Sequence[dict], device) -> Dict[str, torch.Tensor]:
    """Scene dicts (``harness.scenes.make_scenes``) as one concatenated
    block on ``device``; ``nodes`` / ``edges`` give each scene's slice."""
    counts = [len(s["gt_class"]) for s in scenes]
    offsets = np.cumsum([0] + counts[:-1])
    cat = lambda k: torch.from_numpy(np.concatenate([s[k] for s in scenes])).to(device)
    ei = np.concatenate([s["edge_index"] + o for s, o in zip(scenes, offsets)])
    e_counts = [len(s["edge_index"]) for s in scenes]
    bounds = lambda c: list(zip(np.cumsum([0] + c[:-1]).tolist(), np.cumsum(c).tolist()))
    return {
        "obj_points": cat("obj_points"), "obj_2d_feats": cat("obj_2d_feats"),
        "descriptor": cat("descriptor"), "gt_class": cat("gt_class").long(),
        "gt_rels": cat("gt_rels"), "edge_index": torch.from_numpy(ei).to(device).long(),
        "batch_ids": torch.from_numpy(np.repeat(np.arange(len(scenes)), counts)).to(device),
        "nodes": bounds(counts), "edges": bounds(e_counts),
    }


def mmgnet_3d(ref, blk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The 3D branch of ``TorchMmgnetOracle`` (the paper's deployment
    protocol): the same layers as its dual forward, without the 2D modules,
    which the 3D stream never reads."""
    ei = blk["edge_index"]
    desc = blk["descriptor"]
    f = ref.mlp_3d(ref.obj_encoder(blk["obj_points"].transpose(1, 2)))
    spatial = desc[:, 3:].clone()
    spatial[:, 6:] = spatial[:, 6:].log()
    f3d = torch.cat([f, spatial], dim=-1)
    d_i, d_j = desc.index_select(0, ei[:, 0]), desc.index_select(0, ei[:, 1])
    ed = torch.cat([d_i[:, :6] - d_j[:, :6], (d_i[:, 6:] / d_j[:, 6:]).log()], dim=-1)
    e3d = ref.rel_encoder_3d(ed.unsqueeze(-1))
    mmg = ref.mmg
    mask, bias = attention_mask_bias(mmg.self_attn_fc, desc[:, :3], blk["batch_ids"], mmg.h)
    f3d = f3d.unsqueeze(0)
    for i in range(mmg.depth):
        f3d = mmg.self_attn[i](f3d, f3d, f3d, bias, mask)
        a3, e3d = mmg.gcn_3ds[i](f3d[0], e3d, ei)
        f3d = a3.unsqueeze(0)
        if i < mmg.depth - 1 or mmg.depth == 1:
            f3d, e3d = F.relu(f3d), F.relu(e3d)
    f3d = f3d[0]
    scale = ref.obj_logit_scale.exp()
    return {"obj_logits_3d": scale * ref.obj_predictor_3d(f3d / f3d.norm(dim=-1, keepdim=True)),
            "rel_cls_3d": ref.rel_predictor_3d(e3d)}


def attention_mask_bias(self_attn_fc, centers: torch.Tensor, batch_ids: torch.Tensor,
                        heads: int):
    """The reference's block-diagonal scene mask and distance bias
    (network_MMG.py:160-178), built scene by scene."""
    n = centers.shape[0]
    mask = centers.new_zeros(1, 1, n, n)
    bias = centers.new_zeros(1, heads, n, n)
    count = 0
    for b in range(int(batch_ids.max().item()) + 1):
        idx = torch.where(batch_ids == b)[0]
        k = len(idx)
        delta = centers[None, idx, :].expand(k, k, 3) - centers[idx, None, :].expand(k, k, 3)
        dist = delta.pow(2).sum(-1, keepdim=True).sqrt()
        w = self_attn_fc(torch.cat([delta, dist], -1).unsqueeze(0))
        mask[:, :, count:count + k, count:count + k] = 1
        bias[:, :, count:count + k, count:count + k] = w.permute(0, 3, 1, 2)
        count += k
    return mask, bias


def mmgnet_dual(ref, blk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``TorchMmgnetOracle``'s dual forward (both branches); the oracle makes
    its masks with the default device, set here to the block's."""
    with torch.device(blk["obj_points"].device):
        return ref(blk["obj_points"], blk["obj_2d_feats"], blk["edge_index"],
                   blk["descriptor"], blk["batch_ids"])


def sgfn_forward(ref, blk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``TorchSGFNOracle``'s forward: log-softmax object scores, sigmoid
    predicate scores (the masks made on the block's device)."""
    with torch.device(blk["obj_points"].device):
        return ref(blk["obj_points"], blk["edge_index"], blk["descriptor"], blk["batch_ids"])


def dynamic_rel_weights(gt_rels: torch.Tensor) -> torch.Tensor:
    """WEIGHT_EDGE = DYNAMIC of the reference (op_utils / losses): per
    predicate class, with a leading "none" class that counts the edges with
    no predicate, w = |1 / (log(count + 1) + 1)|; a zero weight takes the
    "none" weight; the "none" slot is then dropped."""
    counts = torch.cat([(gt_rels.sum(-1) == 0).sum()[None].to(gt_rels.dtype),
                        gt_rels.sum(0)])
    w = torch.abs(1.0 / (torch.log(counts + 1.0) + 1.0))
    w = torch.where(w == 0, w[0], w)
    return w[1:]


def sgfn_loss(out: Dict[str, torch.Tensor], blk: Dict[str, torch.Tensor],
              lambda_o: float = 0.1) -> torch.Tensor:
    """The SGFN baseline's objective (baseline_sgfn.py): NLL of the object
    log-probabilities, plus DYNAMIC class-weighted binary cross-entropy of
    the predicate probabilities over every edge and class; lambdas
    normalised by max(1, lambda_o).  The probabilities are clipped to
    [1e-7, 1 - 1e-7]."""
    lam = max(1.0, lambda_o)
    loss_obj = F.nll_loss(out["obj_logits_3d"], blk["gt_class"])
    p = out["rel_cls_3d"].clamp(1e-7, 1 - 1e-7)
    y = blk["gt_rels"]
    w = dynamic_rel_weights(y)
    loss_rel = (-(y * torch.log(p) + (1 - y) * torch.log(1 - p)) * w).mean()
    return (lambda_o / lam) * loss_obj + (1.0 / lam) * loss_rel


def cosine_factor(step: int, decay_steps: int) -> float:
    """Cosine decay from 1 to 0 over ``decay_steps`` updates."""
    t = min(step, decay_steps)
    return 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))


class AdamW:
    """AdamW written out (Loshchilov and Hutter), bias-corrected, weight
    decay ``wd`` decoupled; the rate of update ``t`` (from 0) is
    ``lr * cosine_factor(t, decay_steps)``."""

    def __init__(self, params: List[torch.Tensor], lr: float, decay_steps: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0):
        self.params, self.lr, self.decay_steps = params, lr, decay_steps
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = self.lr * cosine_factor(self.t, self.decay_steps)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - lr * self.wd)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))
