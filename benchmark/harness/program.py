"""The program under test, reached only through its public entries: the
registry, the checkpoint import, the server, ``evaluate``, the resident
loaders and the train steps of ``vlsat_tpu_torch``.

Everything that imports the program does so inside a function, so that the
benchmark's modules import without it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.harness.weights import build_reference
from benchmark.reference import oracle


def build(cfg: dict, seed: int, device, mark=lambda what: None) -> tuple:
    """(port model, port loss, weights) of configuration ``cfg``: the
    weights drawn from ``seed`` on ``device`` in the original's checkpoint
    layout (host arrays by child module), and the port's registry model
    loading them through ``interop.torch_import``, on ``device``.  No
    reference module is kept: ``reference`` builds it from the seed once
    the window has closed.  ``cfg["dropout"]`` sets the rate of every
    dropout layer of the port's model where the configuration states it."""
    from vlsat_tpu_torch.config.config import load_config
    from vlsat_tpu_torch.interop import torch_import
    from vlsat_tpu_torch.models.layers import Dropout
    from vlsat_tpu_torch.models.registry import build_model

    mark("program imported")
    drawn = reference(cfg, seed, device)
    synchronize(device)
    mark("weights drawn on the device")
    layout = getattr(oracle, cfg["reference"]["layout"])(drawn)
    del drawn
    mark("weights copied to the host in the checkpoint layout")
    mcfg = load_config(overrides={"MODEL": cfg["MODEL"]}).MODEL
    model, loss = build_model(cfg["NAME"], cfg["num_obj_classes"], cfg["num_rel_classes"], mcfg)
    variables = getattr(torch_import, cfg["import"])(layout, **cfg.get("import_kwargs", {}))
    model.load_state_dict(torch_import.to_state_dict(variables, model))
    if "dropout" in cfg:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = float(cfg["dropout"])
    model = model.to(device).eval()
    mark("program's model built and loaded")
    return model, loss, layout


def reference(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The plain reference of configuration ``cfg`` on ``device``, its
    weights drawn from ``seed`` (``build`` draws the program's through it)."""
    r = cfg["reference"]
    return build_reference(getattr(oracle, r["class"]), device, seed, **r["kwargs"])


def settle() -> None:
    """The end of set-up: collect what set-up left, and freeze the objects
    that remain (``gc.freeze``), so that the window's full collections walk
    only what the window allocates, as a server frozen after start-up
    does."""
    import gc

    gc.collect()
    gc.freeze()


def bucket_rows(sizes: Sequence[int]) -> Dict[int, List[int]]:
    """The scenes of each of the program's node buckets (its
    ``scene.DEFAULT_NODE_BUCKETS``), by their node counts ``sizes``."""
    from vlsat_tpu_torch.scene import DEFAULT_NODE_BUCKETS, pick_bucket

    groups: Dict[int, List[int]] = {}
    for i, n in enumerate(sizes):
        groups.setdefault(pick_bucket(int(n), DEFAULT_NODE_BUCKETS), []).append(i)
    return groups


def memory_pack(scenes: Sequence[dict], feat_dim: int = 512):
    """A packed split held in memory: a ``data.packed.PackedScenes`` whose
    per-bucket stacked arrays (one a field, padded by the program's
    ``scene.pad_scene``) live in memory instead of on disk.  Its ``rows``
    maps each bucket to the scene indices of its rows, in order."""
    from vlsat_tpu_torch.data.packed import PackedScenes
    from vlsat_tpu_torch.scene import pad_scene

    groups = bucket_rows([len(s["gt_class"]) for s in scenes])
    pack = PackedScenes.__new__(PackedScenes)
    pack.root, pack.variants, pack.buckets = None, 1, sorted(groups)
    pack._max_gt, pack.text_table, pack.w_cls_obj, pack.w_cls_rel = None, None, None, None
    pack._arrays, pack.manifest = {}, {"format": 2, "buckets": {}}
    for b, idx in sorted(groups.items()):
        padded = [pad_scene(scenes[i]["obj_points"], scenes[i]["descriptor"],
                            scenes[i]["obj_2d_feats"], scenes[i]["gt_class"],
                            scenes[i]["edge_index"], scenes[i]["gt_rels"], n_max=b,
                            feat_dim=feat_dim) for i in idx]
        for f in padded[0]:
            pack._arrays[(0, b, f)] = np.stack([p[f] for p in padded])
        pack.manifest["buckets"][str(b)] = {"count": len(idx), "fields": list(padded[0])}
    pack.rows = groups
    return pack


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepSpans:
    """Host spans of the program's step calls: a wrapper around an eval or
    train step records each call's start and end (``time.perf_counter``),
    and nothing else; ``note`` is the caller's label of each call."""

    def __init__(self):
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.notes: List[object] = []

    def wrap(self, step, note=None):
        def wrapped(*args):
            t0 = time.perf_counter()
            out = step(*args)
            self.starts.append(t0)
            self.ends.append(time.perf_counter())
            self.notes.append(note(*args) if note is not None else None)
            return out

        wrapped.device = step.device
        return wrapped


def memory_peak(device) -> int:
    """Peak bytes allocated on the card by this process so far (0 on the
    CPU)."""
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def power_limit(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, for the
    record beside the numbers ("" where it cannot say)."""
    import subprocess

    if device.type != "cuda":
        return ""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return res.stdout.strip()


def free(device) -> None:
    """Return the card's cached blocks once the program's state is dropped."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
