"""Program export and its numeric cross-check (counterpart of
``vlsat_tpu/utils/export.py``): where JAX lowers to StableHLO, the port
exports a ``torch.export`` program (``.pt2``) and writes its printed graph,
then checks the exported program against eager execution at two shape
buckets with the reference's ONNX-check gate (rtol 1e-3, atol 1e-5;
src/utils/op_utils.py:283-303).  A ``torch.export`` program has static
shapes, so each bucket is exported, written and checked on its own.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree


class _Call(nn.Module):
    """A plain callable as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_and_check(fn, args_small: Sequence, args_large: Sequence, out_dir: str,
                     name: str, rtol: float = 1e-3, atol: float = 1e-5) -> dict:
    """Export ``fn`` (a module or a callable of tensors) at each argument
    set under ``torch.no_grad``, write ``<name>.<small|large>.pt2`` and
    ``.graph.txt`` under ``out_dir``, and hold every output leaf of the
    exported program against ``fn`` run eagerly.  Returns the paths and
    ``checked_small`` / ``checked_large``."""
    os.makedirs(out_dir, exist_ok=True)
    module = fn if isinstance(fn, nn.Module) else _Call(fn)
    report = {}
    for tag, args in (("small", args_small), ("large", args_large)):
        args = tuple(args)
        with torch.no_grad():
            ep = torch.export.export(module, args)
            exported = _pytree.tree_leaves(ep.module()(*args))
            eager = _pytree.tree_leaves(module(*args))
        path = os.path.join(out_dir, f"{name}.{tag}.pt2")
        torch.export.save(ep, path)
        with open(os.path.join(out_dir, f"{name}.{tag}.graph.txt"), "w") as f:
            f.write(str(ep.graph_module.code))
        if len(exported) != len(eager):
            raise AssertionError(f"{tag}: {len(exported)} exported outputs, {len(eager)} eager")
        for got, want in zip(exported, eager):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=rtol, atol=atol)
        report[f"program_{tag}"] = path
        report[f"checked_{tag}"] = True
    return report


def trace_model(runner, out_dir: str) -> dict:
    """Export the runner's model's eval forward (the full forward, as
    ``--mode eval`` runs it) with its loaded weights at two buckets of
    synthetic xyz scenes, on the runner's device, and check both
    programs."""
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.serving_export import ServingForward

    model = runner.model.eval()
    cfg = model.cfg
    kw = dict(num_points=32, feat_dim=getattr(cfg, "clip_feat_dim", 512),
              num_obj_classes=cfg.num_obj_classes, num_rel_classes=cfg.num_rel_classes)
    fields = ("obj_points", "obj_mask", "descriptor", "obj_2d_feats", "edge_index",
              "edge_mask")

    def args(batch):
        return tuple(getattr(batch, f).to(runner.device) for f in fields)

    small = args(make_batch(node_counts=(5,), bucket=8, **kw))
    large = args(make_batch(node_counts=(9, 11), bucket=12, **kw))
    fwd = ServingForward(model, cfg.num_rel_classes, branch_3d_only=False)
    report = export_and_check(fwd, small, large, out_dir, f"{type(model).__name__.lower()}_eval")
    print(f"traced -> {report['program_small']}, {report['program_large']}")
    return report
