"""Weight bridge: the JAX package's flax ``MMGNet`` variables -> the port's
``state_dict``, and back.

Input: ``params`` and ``batch_stats`` as nested dicts of numpy arrays (the
trees of ``vlsat_tpu.models.MMGNet.init``).  Rules:

  * a Dense kernel (in, out) becomes a Linear weight (out, in);
  * a ChannelDense/HeadMLP kernel (``.../edgeatten/nn/convK``) keeps its
    (C, F) layout as ``kernel``;
  * LayerNorm and MaskedBatchNorm ``scale`` becomes ``weight``; ``bias``
    stays ``bias``;
  * batch_stats ``mean``/``var`` become ``running_mean``/``running_var``;
  * ``obj_logit_scale`` carries over as is.

The train-only subtree ``triplet_projector_2d`` (``_SKIP``) is skipped by
name; any other leaf that the port's model has no slot for raises, and so
does a slot that no leaf fills.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig

_SKIP = re.compile(r"^triplet_projector_2d(/|$)")
_CHANNEL_DENSE = re.compile(r"(^|/)edgeatten/nn/conv\d+$")
_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _expected(cfg: MMGNetConfig) -> Dict[str, Tuple[int, ...]]:
    with torch.device("meta"):
        model = MMGNet(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                       cfg: MMGNetConfig = MMGNetConfig()) -> Dict[str, torch.Tensor]:
    """Convert flax variables to the state_dict of ``MMGNet(cfg)``."""
    expected = _expected(cfg)
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, arr: np.ndarray, src: str):
        if key not in expected:
            raise KeyError(f"flax leaf {src!r} has no slot in the port ({key!r})")
        if tuple(arr.shape) != expected[key]:
            raise ValueError(f"flax leaf {src!r}: shape {arr.shape} != {expected[key]}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    for path, arr in _flatten(params).items():
        if _SKIP.match(path):
            continue
        mod, _, leaf = path.rpartition("/")
        prefix = mod.replace("/", ".") + "." if mod else ""
        if leaf == "kernel" and _CHANNEL_DENSE.search(mod):
            put(prefix + "kernel", arr, path)
        elif leaf == "kernel":
            put(prefix + "weight", np.ascontiguousarray(arr.T), path)
        elif leaf in _PARAM_LEAF:
            put(prefix + _PARAM_LEAF[leaf], arr, path)
        elif path == "obj_logit_scale":
            put(path, arr, path)
        else:
            raise KeyError(f"flax leaf {path!r} is not a known parameter kind")
    for path, arr in _flatten(batch_stats).items():
        if _SKIP.match(path):
            continue
        mod, _, leaf = path.rpartition("/")
        if leaf not in _STAT_LEAF:
            raise KeyError(f"flax batch_stats leaf {path!r} is not mean/var")
        put(mod.replace("/", ".") + "." + _STAT_LEAF[leaf], arr, path)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"no flax leaf for port parameters {missing}")
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict, Dict]:
    """The inverse of :func:`flax_to_state_dict` over every parameter:
    returns (params, batch_stats) as nested dicts of numpy arrays."""
    params: Dict = {}
    stats: Dict = {}
    stat_names = {v: k for k, v in _STAT_LEAF.items()}

    def put(tree: Dict, path: str, arr: np.ndarray):
        *mods, leaf = path.split("/")
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = arr

    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        mod, _, leaf = key.rpartition(".")
        mod = mod.replace(".", "/")
        prefix = mod + "/" if mod else ""
        if leaf in stat_names:
            put(stats, prefix + stat_names[leaf], arr)
        elif leaf == "kernel":
            put(params, prefix + "kernel", arr)
        elif leaf == "weight" and arr.ndim == 2:
            put(params, prefix + "kernel", np.ascontiguousarray(arr.T))
        elif leaf == "weight":
            put(params, prefix + "scale", arr)
        else:
            put(params, prefix + leaf, arr)
    return params, stats
