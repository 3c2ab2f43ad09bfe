"""Keras-style console progress bar with running-average metrics (a copy of
``vlsat_tpu/utils/progbar.py``, which imports no JAX).

Functional counterpart of the reference's ``Progbar``
(src/utils/op_utils.py:113-276): a fixed-width bar, per-step ETA /
ms-per-step, and metric values averaged over the steps seen since the
last report, with "stateful" metrics displayed as-is.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, List, Optional, Tuple


class Progbar:
    def __init__(self, target: Optional[int], width: int = 20, verbose: int = 1,
                 stateful_metrics: Optional[Iterable[str]] = None,
                 stream=None):
        self.target = target
        self.width = width
        self.verbose = verbose
        self.stateful = set(stateful_metrics or [])
        self.stream = stream or sys.stdout
        self._values = {}
        self._seen = 0
        self._start = time.time()
        self._last_width = 0

    def update(self, current: int, values: Optional[List[Tuple[str, float]]] = None):
        values = values or []
        for name, v in values:
            if name in self.stateful:
                self._values[name] = (float(v), 1)
            else:
                tot, cnt = self._values.get(name, (0.0, 0))
                self._values[name] = (tot + float(v), cnt + 1)
        self._seen = current
        if self.verbose != 1:
            return
        now = time.time()
        if self.target is not None:
            frac = current / max(self.target, 1)
            filled = int(self.width * frac)
            bar = "[" + "=" * filled + ">" * (filled < self.width) + "." * (self.width - filled - 1) + "]"
            head = f"{current}/{self.target} {bar}"
        else:
            head = f"{current}"
        dt = (now - self._start) / max(current, 1)
        unit = f"{dt * 1e3:.0f}ms/step" if dt >= 1e-3 else f"{dt * 1e6:.0f}us/step"
        parts = [head, unit]
        for name, (tot, cnt) in self._values.items():
            parts.append(f"{name}: {tot / max(cnt, 1):.4f}")
        line = " - ".join(parts)
        pad = max(self._last_width - len(line), 0)
        self.stream.write("\r" + line + " " * pad)
        if self.target is not None and current >= self.target:
            self.stream.write("\n")
        self.stream.flush()
        self._last_width = len(line)

    def add(self, n: int, values=None):
        self.update(self._seen + n, values)
