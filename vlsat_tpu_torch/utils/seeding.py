"""Process-level seeding (counterpart of ``vlsat_tpu/utils/seeding.py``).

The model's dropout draws from the generators the train step makes from
its ``rng`` seed; this seeds the data side: NumPy, the standard library
and torch's global generators.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
