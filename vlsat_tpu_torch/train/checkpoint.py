"""Checkpoints with best/latest semantics (counterpart of
``vlsat_tpu/train/checkpoint.py``), stored as ``torch.save`` files.

Each save writes the whole ``TrainState`` (parameters, BatchNorm buffers,
optimizer, scheduler, step) to ``ckpt_<step>.pt`` and records its optional
``eva_res`` metric in ``index.json``.  The manager keeps the latest
``max_to_keep`` checkpoints, the best one by ``eva_res`` (max) and every
checkpoint saved without a metric; ``restore(best=True)`` falls back to the
latest.  Every file is written to a temporary name and moved into place with
``os.replace``, so a crash leaves the previous file whole.  Orbax
checkpoints of the JAX package are not read: ``interop.from_flax`` carries
a JAX state across instead.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import torch

from vlsat_tpu_torch.train.state import TrainState

_INDEX = "index.json"


def _write_atomic(path: str, write: Callable[[str], None]) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._open()

    def _open(self) -> None:
        os.makedirs(self._directory, exist_ok=True)
        self._metrics: Dict[int, Optional[float]] = {}
        index = os.path.join(self._directory, _INDEX)
        if os.path.exists(index):
            with open(index) as f:
                self._metrics = {int(k): v for k, v in json.load(f).items()}

    def _path(self, step: int) -> str:
        return os.path.join(self._directory, f"ckpt_{step}.pt")

    def archive_stale(self) -> str:
        """Move the checkpoint directory aside (checkpoints that no longer
        fit the model) and reopen an empty one; returns the new name."""
        archived = f"{self._directory}.stale-{int(time.time())}"
        os.rename(self._directory, archived)
        self._open()
        return archived

    def save(self, state: TrainState, eva_res: Optional[float] = None) -> None:
        step = int(state.step)
        _write_atomic(self._path(step), lambda p: torch.save(state.state_dict(), p))
        self._metrics[step] = None if eva_res is None else float(eva_res)
        steps = sorted(self._metrics)
        keep = set(steps[-self._max_to_keep:]) | {s for s in steps if self._metrics[s] is None}
        if self.best_step is not None:
            keep.add(self.best_step)
        dropped = [s for s in steps if s not in keep]
        self._metrics = {s: self._metrics[s] for s in steps if s in keep}

        def write_index(p):
            with open(p, "w") as f:
                json.dump({str(s): m for s, m in self._metrics.items()}, f)
        _write_atomic(os.path.join(self._directory, _INDEX), write_index)
        for s in dropped:  # only once the index no longer names them
            os.remove(self._path(s))

    def _load(self, best: bool, device) -> Optional[dict]:
        step = self.best_step if best else self.latest_step
        if step is None and best:
            step = self.latest_step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def restore(self, state: TrainState, best: bool = False,
                device=None) -> Optional[TrainState]:
        """Load the best (``best=True``, else the latest) checkpoint into
        ``state`` in place, its tensors mapped onto ``device`` (by default
        the model's); None when there is no checkpoint."""
        if device is None:
            device = next(state.model.parameters()).device
        saved = self._load(best, device)
        if saved is None:
            return None
        state.load_state_dict(saved)
        return state

    def restore_model(self, model: torch.nn.Module, best: bool = True) -> bool:
        """Load only the weights (parameters and BatchNorm statistics) of the
        best (else the latest) checkpoint into ``model``; False when there is
        no checkpoint.  The runner's ``MODEL.use_pretrain`` reads this."""
        saved = self._load(best, next(model.parameters()).device)
        if saved is None:
            return False
        model.load_state_dict(saved["model"])
        return True

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._metrics, default=None)

    @property
    def best_step(self) -> Optional[int]:
        scored = [(m, s) for s, m in self._metrics.items() if m is not None]
        return max(scored)[1] if scored else None
