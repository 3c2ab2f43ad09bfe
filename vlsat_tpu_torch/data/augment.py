"""Point-cloud augmentation + rotation utilities (a copy of
``vlsat_tpu/data/augment.py``).

Counterparts of the reference's rotation helpers (src/utils/op_utils.py:
17-45) and the dataset's random z-rotation augmentation
(src/dataset/dataset_3dssg.py:197-210).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def rotation_matrix(axis, theta: float) -> np.ndarray:
    """Rodrigues rotation about ``axis`` by ``theta`` radians."""
    axis = np.asarray(axis, np.float64)
    axis = axis / math.sqrt(float(np.dot(axis, axis)))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([
        [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
        [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
        [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc],
    ])


def rotation_matrix_from_vectors(vec1, vec2) -> np.ndarray:
    """Rotation aligning vec1 to vec2 (op_utils.py:33-45)."""
    a = (np.asarray(vec1) / np.linalg.norm(vec1)).reshape(3)
    b = (np.asarray(vec2) / np.linalg.norm(vec2)).reshape(3)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = float(np.linalg.norm(v))
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s ** 2))


def random_z_rotation(points: np.ndarray, rng: Optional[np.random.RandomState] = None,
                      normal_offset: Optional[int] = None) -> np.ndarray:
    """Random rotation about z around the centroid (dataset_3dssg.py:
    197-210); rotates normals too when ``normal_offset`` gives their
    starting channel."""
    rng = rng or np.random.RandomState()
    m = rotation_matrix([0, 0, 1], float(rng.uniform(0, 2 * np.pi)))
    out = points.copy()
    centroid = out[:, :3].mean(0)
    out[:, :3] = (out[:, :3] - centroid) @ m.T
    if normal_offset is not None:
        out[:, normal_offset:normal_offset + 3] = \
            out[:, normal_offset:normal_offset + 3] @ m.T
    return out
