"""Class / relation occurrence statistics -> loss weights (a copy of
``vlsat_tpu/data/weights.py``).

Counterpart of data_processing/compute_weight_occurrences.py:38-114 plus
the dataset-side normalization (src/dataset/dataset_3dssg.py:98-109):
  w = sum(counts) / (counts + 1) / sum(counts), then w /= w.max().
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def count_occurrences(
    class_names: Sequence[str],
    relation_names: Sequence[str],
    data: dict,
    selected_scans: Sequence[str] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    o_obj = np.zeros(len(class_names))
    o_rel = np.zeros(len(relation_names))
    selected = set(selected_scans) if selected_scans is not None else None
    for scan in data["scans"]:
        if selected is not None and scan["scan"] not in selected:
            continue
        inst = {}
        for k, v in scan["objects"].items():
            inst[int(k)] = v
            if v in class_names:
                o_obj[class_names.index(v)] += 1
        for rel in scan["relationships"]:
            if rel[3] not in relation_names:
                continue
            if rel[0] == 0 or rel[1] == 0:
                raise RuntimeError("found obj or sub id 0")
            if rel[0] not in inst or rel[1] not in inst:
                continue
            o_rel[relation_names.index(rel[3])] += 1
    return o_obj, o_rel


def normalized_weights(counts: np.ndarray, none_boost: bool = False) -> np.ndarray:
    c = counts.astype(np.float64).copy()
    if none_boost:  # single-label mode sets the 'none' slot heavy (":103-104")
        c[0] = c.max() * 10
    if c.sum() == 0:
        return np.ones_like(c, dtype=np.float32)
    w = c.sum() / (c + 1) / c.sum()
    w /= w.max()
    return w.astype(np.float32)
