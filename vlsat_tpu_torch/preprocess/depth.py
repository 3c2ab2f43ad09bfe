"""Depth back-projection and per-frame visible-instance lists (counterpart
of ``vlsat_tpu/preprocess/depth.py``).

Back-project each depth map to world space, give every pixel its nearest
labelled instance point, and record which instances each frame sees (the
depth-based alternative to the CLIP projection pipeline,
data/get_object_frame.py:128-183).

The back-projection and the nearest-point search run on the device (the
card unless the caller passes ``device="cpu"``).  The search keeps the JAX
package's arithmetic, ``((q - p)^2).sum(-1)`` summed x, y, z in that order
and then argmin with ties to the first index, so its assignments equal the
NumPy ones on the same points.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vlsat_tpu_torch.device import resolve_device


def backproject_depth(depth: torch.Tensor, intrinsic: torch.Tensor,
                      cam_to_world: torch.Tensor) -> torch.Tensor:
    """depth (H, W) + intrinsic (3, 3) + pose (4, 4) -> world points (H*W, 3),
    on the tensors' device.

    Pixels at (u, v) unproject as z * K^-1 [u, v, 1]; zero-depth pixels
    produce the camera origin (filter with depth > 0 downstream).
    """
    h, w = depth.shape
    dev = depth.device
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(-1, 3)
    rays = pix @ torch.linalg.inv(intrinsic).T
    cam = rays * depth.reshape(-1, 1)
    ph = torch.cat([cam, torch.ones((cam.shape[0], 1), dtype=cam.dtype, device=dev)], dim=-1)
    return (ph @ cam_to_world.T)[:, :3]


def _nearest(queries: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
             max_dist: float, chunk: int) -> torch.Tensor:
    out = torch.zeros(len(queries), dtype=labels.dtype, device=labels.device)
    for i in range(0, len(queries), chunk):
        q = queries[i:i + chunk]
        diff = q[:, None, :] - points[None, :, :]
        sq = diff * diff
        d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
        nn = torch.argmin(d2, dim=1)
        ok = torch.sqrt(d2.gather(1, nn[:, None])[:, 0]) <= max_dist
        out[i:i + chunk] = torch.where(ok, labels[nn], torch.zeros_like(labels[nn]))
    return out


def nearest_instance(world_pts, labeled_pts, labels, max_dist: float = 0.1,
                     chunk: int = 2048, device=None) -> np.ndarray:
    """Nearest labelled point per query (brute force, ``chunk`` queries at
    a time, on ``device``); 0 when farther than ``max_dist``.  Returns a
    host array of ``labels``' dtype."""
    dev = resolve_device(device)
    lab = np.asarray(labels)
    got = _nearest(torch.as_tensor(np.asarray(world_pts), device=dev),
                   torch.as_tensor(np.asarray(labeled_pts), device=dev),
                   torch.as_tensor(lab.astype(np.int64), device=dev), max_dist, chunk)
    return got.cpu().numpy().astype(lab.dtype)


def visible_instances_per_frame(
    depths: List[np.ndarray], intrinsic: np.ndarray, poses: List[np.ndarray],
    labeled_pts: np.ndarray, labels: np.ndarray,
    min_pixels: int = 50, stride: int = 8, max_dist: float = 0.1, device=None,
) -> Dict[int, List[int]]:
    """frame index -> instance ids visible with >= min_pixels assigned
    pixels (subsampled by ``stride`` for tractability)."""
    dev = resolve_device(device)
    # subsampling the depth map rescales pixel coordinates by `stride`, so
    # the intrinsic's focal lengths and principal point shrink with it
    k_sub = np.asarray(intrinsic[:3, :3], np.float32).copy()
    k_sub[0, :] /= stride
    k_sub[1, :] /= stride
    k_t = torch.as_tensor(k_sub, device=dev)
    pts_t = torch.as_tensor(np.asarray(labeled_pts), device=dev)
    lab_t = torch.as_tensor(np.asarray(labels).astype(np.int64), device=dev)
    out: Dict[int, List[int]] = {}
    for f, (d, pose) in enumerate(zip(depths, poses)):
        ds = torch.as_tensor(np.ascontiguousarray(d[::stride, ::stride]), dtype=torch.float32,
                             device=dev)
        world = backproject_depth(ds, k_t, torch.as_tensor(np.asarray(pose, np.float32),
                                                           device=dev))
        inst = _nearest(world[ds.reshape(-1) > 0], pts_t, lab_t, max_dist, 2048)
        ids, counts = torch.unique(inst[inst != 0], return_counts=True)
        out[f] = [int(i) for i, c in zip(ids.tolist(), counts.tolist())
                  if c * stride * stride >= min_pixels]
    return out
