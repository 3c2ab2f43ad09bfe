"""Metric logging: a JSONL event log always, TensorBoard when it imports (a
copy of ``vlsat_tpu/utils/logging.py``, which imports no JAX).

Each ``log`` call appends one record ``{"step", "time", <name>: float}`` to
``<log_dir>/events.jsonl``; ``Misc*`` items (progress-bar counters) are
skipped.  The records are the JAX package's, so one reader serves both.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Tuple


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the tensorboard package is optional
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def log(self, items: Iterable[Tuple[str, float]], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        for name, value in items:
            if name.startswith("Misc"):
                continue
            rec[name] = float(value)
            if self._tb is not None:
                self._tb.add_scalar(name, float(value), int(step))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
