"""AdamW with per-module learning-rate groups and a cosine schedule
(counterpart of ``vlsat_tpu/train/optim.py``).

  group          LR factor   parameters
  base           1           encoders, heads, projectors, mlp_3d, logit scale
  mmg_obj        1/4         MMG parameters except the edge-update MLPs
  mmg_rel        1/2         every ``nn_edge`` parameter under ``mmg``
  obj_predictor  1/10        the two cosine classifiers
  frozen         0           clip_adapter (and, with ``freeze_non_predictor``,
                             every top module without "predictor" in its name)

Each group is one ``torch.optim.AdamW`` parameter group; frozen parameters
are left out of the optimizer (optax's ``set_to_zero``).  The schedule is a
``LambdaLR`` with optax's closed forms, stepped once per update after the
optimizer, so step t uses the rate at t as optax evaluates its schedule at
the count before the update.  Weight decay is 0 (the shipped config; torch's
AdamW would default to 0.01).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

GROUPS = (("base", 1.0), ("mmg_obj", 0.25), ("mmg_rel", 0.5), ("obj_predictor", 0.1))


def label_params(names: Iterable[str], freeze_non_predictor: bool = False) -> Dict[str, str]:
    """Group label of every parameter name of a model of the port
    (``named_parameters`` keys), as ``label_params`` labels the bridged flax
    leaf."""
    labels = {}
    for name in names:
        top = name.split(".", 1)[0]
        if top == "clip_adapter" or (freeze_non_predictor and "predictor" not in top):
            labels[name] = "frozen"
        elif top in ("obj_predictor_2d", "obj_predictor_3d"):
            labels[name] = "obj_predictor"
        elif top == "mmg":
            labels[name] = "mmg_rel" if "nn_edge" in name else "mmg_obj"
        else:
            labels[name] = "base"
    return labels


def cosine_decay(decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(1, decay_steps, alpha=0): stays at 0 after
    ``decay_steps`` (``CosineAnnealingLR`` would climb back)."""
    def factor(step: int) -> float:
        t = min(step, decay_steps)
        return 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    return factor


def batch_multiplicative_schedule(base_lr: float, factor: float = 0.95,
                                  batch_size: int = 1,
                                  ref_batch_size: int = 1) -> Callable[[int], float]:
    """The reference's ``BatchMultiplicativeLR`` semantics (optim.py:46-58):
    each step multiplies the rate by ``factor`` scaled by the seen batch
    fraction."""
    exponent = batch_size / max(ref_batch_size, 1)

    def schedule(step: int) -> float:
        return base_lr * (factor ** (step * exponent))
    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` returns: the counterpart of the optax
    transformation.  ``init(model)`` builds the AdamW over the model's
    parameter groups and its scheduler; ``update(optimizer, scheduler)``
    applies one step."""

    lr: float = 1e-4
    max_iteration: int = 100_000
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    schedule: str = "Cosine"
    freeze_non_predictor: bool = False

    def factor(self) -> Callable[[int], float]:
        """The schedule as a multiplier of each group's base rate."""
        if self.schedule == "Cosine":
            return cosine_decay(self.max_iteration)
        if self.schedule == "BatchMultiplicative":
            return batch_multiplicative_schedule(1.0)
        raise ValueError(f"unknown LR schedule {self.schedule!r}")

    def param_groups(self, model: nn.Module) -> List[dict]:
        """One AdamW group per non-empty label, with the parameter names
        beside the parameters; the frozen ones are left out."""
        named = list(model.named_parameters())
        labels = label_params((n for n, _ in named), self.freeze_non_predictor)
        groups = []
        for label, scale in GROUPS:
            members = [(n, p) for n, p in named if labels[n] == label]
            if members:
                groups.append({"params": [p for _, p in members],
                               "names": [n for n, _ in members], "label": label,
                               "lr": self.lr * scale})
        return groups

    def init(self, model: nn.Module
             ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
        factor = self.factor()  # an unknown schedule raises before anything is built
        opt = torch.optim.AdamW(self.param_groups(model), lr=self.lr,
                                betas=(self.b1, self.b2), eps=1e-8,
                                weight_decay=self.weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)

    @staticmethod
    def update(optimizer: torch.optim.Optimizer, scheduler) -> None:
        """One update at the current rates, then the schedule moves on."""
        optimizer.step()
        scheduler.step()


def make_optimizer(lr: float = 1e-4, max_iteration: int = 100_000,
                   weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                   schedule: str = "Cosine",
                   freeze_non_predictor: bool = False) -> OptimizerSpec:
    return OptimizerSpec(lr, max_iteration, weight_decay, b1, b2, schedule,
                         freeze_non_predictor)


def set_schedule_position(scheduler: torch.optim.lr_scheduler.LambdaLR, step: int) -> None:
    """Put ``scheduler`` (and its optimizer's rates) at ``step`` updates."""
    scheduler.last_epoch = step
    lrs = [base * f(step) for base, f in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
