"""Serving artifacts: the eval forward exported with ``torch.export``
(counterpart of ``vlsat_tpu/serving_export.py``).

An artifact directory holds one ``torch.export`` program per node bucket
(``bucket_<n>.pt2``, the weights stored inside) over the six serving arrays,
and a ``manifest.json`` with the serving contract: batch, buckets,
point/feature dims, output names, the device it was exported for, and the
format version.  ``load_serving_artifact`` returns an ``ExportedEvalStep``,
which ``serving.BatchedServer`` takes in place of the live eval step
(``eval_step=``).  Loading imports the operator registrations
(``vlsat_tpu_torch.ops.kernels``: the two CUDA kernels are operators inside
the program) and nothing of ``vlsat_tpu_torch.models``: an artifact runs
without the model source.

An artifact runs on the device type it was exported for: exported on the
card, it runs on a card; exported on the CPU, on the CPU.  The loader
raises on any other device.  The program takes float32: the f16 wire
decode stays outside it, in ``ExportedEvalStep``.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

import vlsat_tpu_torch.ops.kernels  # noqa: F401  (registers vlsat::* for the programs)
from vlsat_tpu_torch.data.wire import decode_wire
from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.scene import SceneBatch, full_edge_index

MANIFEST_NAME = "manifest.json"
_FORMAT_VERSION = 1
_OUT_KEYS = ("obj_logits_3d", "rel_cls_3d", "obj_logits_2d", "rel_cls_2d")


class ServingForward(nn.Module):
    """The eval forward of ``model`` over the serving arrays only (no GT
    fields: the eval forward reads none, so they are zeros), returning
    the outputs of ``_OUT_KEYS`` that the model gives."""

    def __init__(self, model: nn.Module, num_rel_classes: int, branch_3d_only: bool):
        super().__init__()
        self.model = model
        self.num_rel_classes = num_rel_classes
        self.kwargs = {"branch_3d_only": True} if branch_3d_only else {}

    def forward(self, obj_points, obj_mask, descriptor, obj_2d_feats, edge_index, edge_mask):
        b, n = obj_mask.shape
        batch = SceneBatch(
            obj_points=obj_points, obj_mask=obj_mask, descriptor=descriptor,
            obj_2d_feats=obj_2d_feats,
            gt_class=torch.zeros(b, n, dtype=torch.int32, device=obj_mask.device),
            edge_index=edge_index, edge_mask=edge_mask,
            gt_rels=torch.zeros(b, edge_mask.shape[1], self.num_rel_classes,
                                device=obj_mask.device))
        out = self.model(batch, **self.kwargs)
        return {k: out[k] for k in _OUT_KEYS if k in out}


def _example_args(max_batch: int, bucket: int, num_points: int, point_dim: int,
                 feat_dim: int, device) -> Tuple[torch.Tensor, ...]:
    """Example inputs of one bucket's program: one full scene of ``bucket``
    nodes and empty ones after it (the values do not enter the program)."""
    e = bucket * (bucket - 1)
    mask = torch.zeros(max_batch, bucket, dtype=torch.bool)
    mask[0] = True
    edge_index = torch.zeros(max_batch, e, 2, dtype=torch.int32)
    edge_index[0] = torch.from_numpy(full_edge_index(bucket))
    edge_mask = torch.zeros(max_batch, e, dtype=torch.bool)
    edge_mask[0] = True
    desc = torch.zeros(max_batch, bucket, 11)
    desc[..., 6:] = 1.0
    args = (torch.zeros(max_batch, bucket, num_points, point_dim), mask, desc,
            torch.zeros(max_batch, bucket, feat_dim), edge_index, edge_mask)
    return tuple(a.to(device) for a in args)


def export_serving_artifact(model: nn.Module, out_dir: str, *,
                            buckets: Sequence[int] = (8, 16), max_batch: int = 32,
                            num_points: int = 128, point_dim: int = 3, feat_dim: int = 512,
                            branch_3d_only: bool = True, device=None) -> Dict:
    """Export ``model``'s eval forward with its current weights (from a
    copy in eval mode on ``device``, the card unless the caller passes
    ``device="cpu"``; under ``torch.no_grad``) once per bucket; returns the
    manifest, which also records each bucket's export seconds."""
    dev = resolve_device(device)
    num_rel = int(model.cfg.num_rel_classes)
    fwd = ServingForward(copy.deepcopy(model).to(dev).eval(), num_rel, branch_3d_only)
    os.makedirs(out_dir, exist_ok=True)
    entries, out_keys = {}, []
    for bucket in sorted({int(b) for b in buckets}):
        t0 = time.perf_counter()
        with torch.no_grad():
            ep = torch.export.export(fwd, _example_args(max_batch, bucket, num_points,
                                                       point_dim, feat_dim, dev))
        fname = f"bucket_{bucket}.pt2"
        torch.export.save(ep, os.path.join(out_dir, fname))
        out_keys = list(ep.call_spec.out_spec.context)
        entries[str(bucket)] = {"file": fname, "num_edges": bucket * (bucket - 1),
                                "export_s": time.perf_counter() - t0}
    manifest = {
        "format_version": _FORMAT_VERSION, "torch_version": torch.__version__,
        "platforms": [dev.type], "max_batch": max_batch, "num_points": num_points,
        "point_dim": point_dim, "feat_dim": feat_dim, "num_rel_classes": num_rel,
        "branch_3d_only": branch_3d_only, "outputs": out_keys, "buckets": entries,
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


class ExportedEvalStep:
    """A loaded serving artifact with the eval step's signature:
    ``step(state, batch) -> {output name: tensor}``.  ``state`` is ignored
    (the weights are in the programs); the (wire-encoded) host batch moves
    to ``device`` and widens to f32 there, then runs its bucket's
    program.  ``BatchedServer(eval_step=...)`` and ``eval.engine.evaluate``
    take it as they take ``make_eval_step``'s."""

    def __init__(self, manifest: Dict, programs: Dict[int, nn.Module], path: str, device):
        self.manifest = manifest
        self.path = path
        self.device = device
        self._programs = programs

    @property
    def buckets(self) -> Tuple[int, ...]:
        return tuple(sorted(self._programs))

    def __call__(self, state, batch: SceneBatch) -> Dict[str, torch.Tensor]:
        m = self.manifest
        b, n = batch.obj_mask.shape
        program = self._programs.get(int(n))
        if program is None:
            raise ValueError(f"no exported program for bucket {n}; the artifact at "
                             f"{self.path} has buckets {self.buckets}")
        if b != m["max_batch"]:
            raise ValueError(f"the artifact was exported for batch {m['max_batch']}, got {b} "
                             "(BatchedServer(pad_to_max=True) pads every batch)")
        if tuple(batch.obj_points.shape[2:]) != (m["num_points"], m["point_dim"]):
            raise ValueError(f"the artifact expects ({m['num_points']}, {m['point_dim']}) "
                             f"points/channels, got {tuple(batch.obj_points.shape[2:])}")
        batch = decode_wire(batch.to(self.device, non_blocking=True))
        with torch.no_grad():
            return dict(program(batch.obj_points, batch.obj_mask, batch.descriptor,
                                batch.obj_2d_feats, batch.edge_index, batch.edge_mask))


def load_serving_artifact(path: str, device=None) -> ExportedEvalStep:
    """Load an artifact directory for ``device`` (the card unless the caller
    passes ``device="cpu"``); raises when the artifact was exported for
    another device type or in another format."""
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported artifact format {manifest.get('format_version')} "
                         f"(this loader reads {_FORMAT_VERSION})")
    dev = resolve_device(device)
    if dev.type not in manifest["platforms"]:
        raise ValueError(f"the artifact at {path} was exported for {manifest['platforms']}, "
                         f"not {dev.type}: export it on the device that serves it")
    programs = {int(bucket): torch.export.load(os.path.join(path, entry["file"])).module()
                for bucket, entry in manifest["buckets"].items()}
    return ExportedEvalStep(manifest, programs, path, dev)
