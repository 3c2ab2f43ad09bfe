"""3RScan rescan alignment (counterpart of ``vlsat_tpu/preprocess/transform.py``;
reference data_processing/transform_ply.py).

Rescans carry a 4x4 transform to their reference scan's frame in
3RScan.json; aligning multiplies homogeneous ROW vectors by the matrix in
float64 (reference ``points4f * matrix``, transform_ply.py:33-34 -- note
the row-vector convention).  Reference scans are plain copies.  Host work.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Iterable, Optional

import numpy as np

from vlsat_tpu_torch.data.ply import read_ply_vertices, write_ply_vertices


def read_transform_matrices(scan3r_json_path: str) -> Dict[str, np.ndarray]:
    """scan_id -> 4x4 rescan->reference transform.

    NOTE the reference keys this dict by ``scans["reference"]``
    (transform_ply.py:47-48), and so does this copy.
    """
    out: Dict[str, np.ndarray] = {}
    with open(scan3r_json_path) as f:
        data = json.load(f)
    for scene in data:
        for scan in scene.get("scans", []):
            if "transform" in scan:
                out[scan["reference"]] = np.asarray(scan["transform"],
                                                   np.float64).reshape(4, 4)
    return out


def apply_transform(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Row-vector homogeneous transform: [x y z 1] @ M."""
    ph = np.concatenate([points, np.ones((len(points), 1), points.dtype)], axis=1)
    return (ph @ matrix)[:, :3].astype(np.float32)


def align_scan(file_in: str, file_out: str, matrix: Optional[np.ndarray]) -> None:
    if matrix is None:
        shutil.copyfile(file_in, file_out)
        return
    ply = read_ply_vertices(file_in)
    pts = apply_transform(ply.points.astype(np.float64), matrix)
    write_ply_vertices(file_out, pts.astype(np.float32),
                       instances=ply.instances, colors=ply.colors)


def align_dataset(scans_root: str, scan_ids: Iterable[str], transforms: Dict[str, np.ndarray],
                  raw_name: str = "labels.instances.annotated.v2.ply",
                  out_name: str = "labels.instances.align.annotated.v2.ply") -> int:
    """Align (or copy) each scan's ``raw_name`` to ``out_name``; scans
    without the raw file or with the output already present are skipped.
    Returns the number written."""
    count = 0
    for sid in scan_ids:
        fi = os.path.join(scans_root, sid, raw_name)
        fo = os.path.join(scans_root, sid, out_name)
        if not os.path.exists(fi) or os.path.exists(fo):
            continue
        align_scan(fi, fo, transforms.get(sid))
        count += 1
    return count
