"""Train state (counterpart of ``vlsat_tpu/train/state.py``).

A torch step updates in place, so the state is the model itself (its
parameters and BatchNorm buffers), the AdamW built over its parameter groups,
the scheduler and the count of updates.  ``state_dict``/``load_state_dict``
carry all four; ``CheckpointManager`` stores exactly that.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vlsat_tpu_torch.models.mmgnet import init_parameters
from vlsat_tpu_torch.train.optim import OptimizerSpec


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def create_train_state(model: nn.Module, optimizer: OptimizerSpec,
                       seed: Optional[int] = None) -> TrainState:
    """The optimizer and scheduler of ``optimizer`` over ``model``'s
    parameter groups, at step 0.  With ``seed`` the weights are first drawn
    anew from it (as the JAX package's ``create_train_state`` initialises
    from its seed); without, the model keeps the weights it has (e.g.
    bridged from flax)."""
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    opt, sched = optimizer.init(model)
    return TrainState(model, opt, sched, 0)
