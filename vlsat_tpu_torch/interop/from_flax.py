"""Weight bridge: the JAX package's flax variables -> the port's
``state_dict``, and back, for every model of the registry.

Input: ``params`` and ``batch_stats`` as nested dicts of numpy arrays (the
trees of a flax model's ``init``) and the port's model they are for.  The
port's module names follow the flax tree, so a leaf's path names its slot.  Rules:

  * a Dense kernel (in, out) becomes a Linear weight (out, in);
  * a ChannelDense/HeadMLP kernel (``.../edgeatten/nn/convK``) keeps its
    (C, F) layout as ``kernel``;
  * LayerNorm and MaskedBatchNorm ``scale`` becomes ``weight``; ``bias``
    stays ``bias``;
  * batch_stats ``mean``/``var`` become ``running_mean``/``running_var``;
  * a top-level ``*logit_scale`` scalar carries over as is.

A leaf that the port's model has no slot for raises, and so does a slot
that no leaf fills: the flax tree must come from an ``istrain=True`` init
(or a training checkpoint), which holds the triplet projectors.

A model that takes flax weights takes flax's numerics with them:
``flax_to_state_dict`` sets the epsilon of every LayerNorm of the model to
flax's 1e-6 (the registry builds torch's 1e-5, the original's).
``tree_to_state_dict`` is the same mapping without that, for trees that
carry the original's weights (``interop.torch_import``).

``train_state_from_flax`` also carries a JAX training run across: optax's
per-group Adam moments and counts become the AdamW state, and the schedule
is put at the run's step, so both packages resume one mid-run state.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from vlsat_tpu_torch.models.transformer import FLAX_LN_EPS, set_layer_norm_eps
from vlsat_tpu_torch.train.optim import OptimizerSpec, set_schedule_position
from vlsat_tpu_torch.train.state import TrainState, create_train_state

_CHANNEL_DENSE = re.compile(r"(^|/)edgeatten/nn/conv\d+$")
_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Leaves by "/"-joined path; optax's ``MaskedNode`` (an empty tuple,
    the slot of a leaf in another group's moments) is dropped."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        elif not (isinstance(v, tuple) and not v):
            out[path] = np.asarray(v)
    return out


def _expected(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _put(out: Dict[str, torch.Tensor], expected: Dict[str, Tuple[int, ...]],
         key: str, arr: np.ndarray, src: str) -> None:
    if key not in expected:
        raise KeyError(f"flax leaf {src!r} has no slot in the port ({key!r})")
    if tuple(arr.shape) != expected[key]:
        raise ValueError(f"flax leaf {src!r}: shape {arr.shape} != {expected[key]}")
    out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))


def _port_params(params: Mapping, expected: Dict[str, Tuple[int, ...]]
                 ) -> Dict[str, torch.Tensor]:
    """A params-shaped tree (the parameters, or an Adam moment of them)
    keyed by the port's names, in the port's layouts."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        mod, _, leaf = path.rpartition("/")
        prefix = mod.replace("/", ".") + "." if mod else ""
        if leaf == "kernel" and _CHANNEL_DENSE.search(mod):
            _put(out, expected, prefix + "kernel", arr, path)
        elif leaf == "kernel":
            _put(out, expected, prefix + "weight", np.ascontiguousarray(arr.T), path)
        elif leaf in _PARAM_LEAF:
            _put(out, expected, prefix + _PARAM_LEAF[leaf], arr, path)
        elif not mod and leaf.endswith("logit_scale"):
            _put(out, expected, path, arr, path)
        else:
            raise KeyError(f"flax leaf {path!r} is not a known parameter kind")
    return out


def flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert flax variables to the state_dict of the port's ``model``, and
    give ``model``'s LayerNorms flax's epsilon."""
    set_layer_norm_eps(model, FLAX_LN_EPS)
    return tree_to_state_dict(params, batch_stats, model)


def tree_to_state_dict(params: Mapping, batch_stats: Mapping,
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """A flax-shaped tree (``params``, ``batch_stats``) as the state_dict of
    the port's ``model``, leaf for leaf; ``model`` is left as it is."""
    expected = _expected(model)
    out = _port_params(params, expected)
    for path, arr in _flatten(batch_stats).items():
        mod, _, leaf = path.rpartition("/")
        if leaf not in _STAT_LEAF:
            raise KeyError(f"flax batch_stats leaf {path!r} is not mean/var")
        _put(out, expected, mod.replace("/", ".") + "." + _STAT_LEAF[leaf], arr, path)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"no flax leaf for port parameters {missing}")
    return out


def _adam_states(opt_state: Any) -> Dict[str, Tuple[int, Mapping, Mapping, list]]:
    """label -> (Adam count, mu, nu, schedule counts) of an optax
    ``multi_transform`` state of ``vlsat_tpu.train.optim.make_optimizer``
    (read by attribute: optax is not imported); the frozen group has none."""
    out = {}
    for label, masked in opt_state.inner_states.items():
        parts = list(masked.inner_state)
        adam = [p for p in parts if hasattr(p, "mu") and hasattr(p, "nu")]
        if adam:
            sched = [int(p.count) for p in parts if getattr(p, "_fields", None) == ("count",)]
            out[label] = (int(adam[0].count), adam[0].mu, adam[0].nu, sched)
    return out


def train_state_from_flax(params: Mapping, batch_stats: Mapping, opt_state: Any, step: int,
                          model: nn.Module, optimizer: OptimizerSpec) -> TrainState:
    """A ``TrainState`` of ``model`` (on its device) that resumes a JAX run
    after ``step`` updates: the bridged weights, AdamW moments ``exp_avg`` /
    ``exp_avg_sq`` from each group's optax ``mu`` / ``nu``, AdamW's step
    from the group's Adam count (bias correction), and the schedule at
    ``step``.  ``optimizer`` must be the port's spec of the JAX run's
    ``make_optimizer`` arguments."""
    step = int(step)
    model.load_state_dict(flax_to_state_dict(params, batch_stats, model))
    state = create_train_state(model, optimizer)
    adam = _adam_states(opt_state)
    expected = _expected(model)
    for group in state.optimizer.param_groups:
        count, mu, nu, sched = adam[group["label"]]
        if any(c != step for c in sched):
            raise ValueError(f"group {group['label']!r}: schedule counts {sched} != step {step}")
        mu, nu = _port_params(mu, expected), _port_params(nu, expected)
        for name, p in zip(group["names"], group["params"]):
            state.optimizer.state[p] = {"step": torch.tensor(float(count)),
                                        "exp_avg": mu[name].to(p.device),
                                        "exp_avg_sq": nu[name].to(p.device)}
    set_schedule_position(state.scheduler, step)
    state.step = step
    return state


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict, Dict]:
    """The inverse of :func:`flax_to_state_dict` over every parameter:
    returns (params, batch_stats) as nested dicts of numpy arrays (copies:
    later updates of the tensors do not reach them)."""
    params: Dict = {}
    stats: Dict = {}
    stat_names = {v: k for k, v in _STAT_LEAF.items()}

    def put(tree: Dict, path: str, arr: np.ndarray):
        *mods, leaf = path.split("/")
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = arr

    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy().copy()  # a CPU tensor's numpy() shares its storage
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
