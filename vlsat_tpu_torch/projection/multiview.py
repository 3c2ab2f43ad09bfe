"""Multi-view projection front-end, the 2D CLIP feature generation
(counterpart of ``vlsat_tpu/projection/multiview.py``; reference
``data/pointcloud2image.py``).

For every annotated instance: project its points into every RGB frame, pick
good views (three quality tiers), crop padded bounding boxes, encode each
crop together with its full frame with an image encoder and save the mean
of the L2-normalised view features -- the sole source of ``obj_2d_feats``.

The projection of an instance into all frames is one batched product on
the device (the card unless the caller asks for the CPU); view selection,
cropping and the mean stay on the host.  The image encoder is any callable
from a list of HxWx3 uint8 arrays to (n, d) features.

Conventions (reference :168-176): extrinsics are world->camera 4x4, the
intrinsic is the 3x4 projection block, and a point is visible when
0 < u < width and 0 < v < height.  A point behind the camera can count as
visible, as in the reference, unless ``require_positive_depth``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlsat_tpu_torch.device import resolve_device


def project_points(
    points: torch.Tensor,       # (P, 3) world coordinates
    extrinsics: torch.Tensor,   # (F, 4, 4) world -> camera
    intrinsic: torch.Tensor,    # (3, 4) or (F, 3, 4)
    width: int,
    height: int,
    require_positive_depth: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (pix (F, P, 2), visible (F, P)) on the tensors' device."""
    ph = torch.cat([points, torch.ones((points.shape[0], 1), dtype=points.dtype,
                                       device=points.device)], dim=-1)
    cam = torch.einsum("fij,pj->fpi", extrinsics, ph)            # (F, P, 4)
    if intrinsic.dim() == 2:
        img = torch.einsum("ij,fpj->fpi", intrinsic, cam)        # (F, P, 3)
    else:
        img = torch.einsum("fij,fpj->fpi", intrinsic, cam)
    z = img[..., 2:3]
    pix = img[..., :2] / z
    visible = ((pix[..., 0] < width) & (pix[..., 0] > 0)
               & (pix[..., 1] < height) & (pix[..., 1] > 0))
    if require_positive_depth:
        visible = visible & (z[..., 0] > 0)
    return pix, visible


def crop_box(pix: np.ndarray, width: int, height: int) -> Tuple[int, int, int, int]:
    """Reference padded bbox (pointcloud2image.py:216-226):
    returns (top, left, bottom, right) in pixel rows/cols."""
    padding_x = min(height * 0.3, 20)
    padding_y = min(width * 0.3, 20)
    top = max(0, int(pix[:, 1].min()) - padding_x)
    left = max(0, int(pix[:, 0].min()) - padding_y)
    bottom = min(int(pix[:, 1].max()) + padding_x, height)
    right = min(int(pix[:, 0].max()) + padding_y, width)
    return int(top), int(left), int(bottom), int(right)


@dataclass
class ViewCrop:
    frame: int
    box: Optional[Tuple[int, int, int, int]]  # None = whole frame (tier C)
    tier: str                                  # 'A' | 'B' | 'C'
    pc_ratio: float


def select_view_crops(
    pix: np.ndarray,            # (F, P, 2)
    visible: np.ndarray,        # (F, P)
    clip_rank: Sequence[int],   # frames sorted by CLIP class similarity
    width: int,
    height: int,
    max_views: int = 5,
) -> List[ViewCrop]:
    """Three-tier view selection (pointcloud2image.py:211-293):
    A = CLIP-ranked frames where the instance projects; B = best frames by
    projected-point ratio; C = top CLIP frame, whole image."""
    out: List[ViewCrop] = []
    for k in clip_rank:
        sel = pix[k][visible[k]]
        if len(sel) == 0:
            continue
        out.append(ViewCrop(int(k), crop_box(sel, width, height), "A",
                            float(visible[k].mean())))
        if len(out) >= max_views:
            return out
    if not out:
        ratios = visible.mean(-1)
        for k in np.argsort(-ratios, kind="stable")[:max_views]:
            sel = pix[k][visible[k]]
            if len(sel) == 0:
                continue
            out.append(ViewCrop(int(k), crop_box(sel, width, height), "B",
                                float(ratios[k])))
    if not out:
        out.append(ViewCrop(int(clip_rank[0]), None, "C", 0.0))
    return out


class MultiViewFeatureExtractor:
    """Per-scene feature generation.

    ``image_encoder``: callable mapping a list of HxWx3 uint8 arrays to
    (n, d) features (e.g. a CLIP vision tower).  The saved artifact keeps
    the reference naming, instance_{id}_class_{name}_origin_view_mean.npy
    (read by the dataset, dataset_3dssg.py:296-297), and each scene appends
    one line an instance to ``project_quality.txt``.  The projection runs
    on ``device`` (the card unless the caller asks for the CPU).
    """

    def __init__(self, image_encoder: Callable, feat_dim: int = 512,
                 max_views: int = 5, device=None):
        self.encode = image_encoder
        self.feat_dim = feat_dim
        self.max_views = max_views
        self.device = resolve_device(device)

    def instance_feature(self, images: Sequence[np.ndarray],
                         crops: Sequence[ViewCrop]) -> np.ndarray:
        views: List[np.ndarray] = []
        for c in crops[: self.max_views]:
            img = images[c.frame]
            if c.box is not None:
                t, l, b, r = c.box
                views.append(img[t:b, l:r])
            views.append(img)  # reference encodes cropped AND full frames
        feats = self.encode(views)
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        return feats.mean(0)

    def process_scene(
        self,
        points: np.ndarray,
        instances: np.ndarray,
        instance_names: Dict[int, str],
        images: Sequence[np.ndarray],
        extrinsics: np.ndarray,
        intrinsic: np.ndarray,
        clip_rank_per_class: Dict[str, Sequence[int]],
        width: int,
        height: int,
        save_dir: Optional[str] = None,
    ) -> Dict[int, np.ndarray]:
        dev = self.device
        extr = torch.as_tensor(np.asarray(extrinsics, np.float32), device=dev)
        intr = torch.as_tensor(np.asarray(intrinsic, np.float32), device=dev)
        results: Dict[int, np.ndarray] = {}
        log: List[str] = []
        for iid, name in instance_names.items():
            pts = points[instances == iid]
            if len(pts) == 0:
                continue
            pix, vis = project_points(
                torch.as_tensor(np.asarray(pts, np.float32), device=dev), extr, intr,
                width, height)
            crops = select_view_crops(
                pix.cpu().numpy(), vis.cpu().numpy(),
                clip_rank_per_class.get(name, range(len(images))),
                width, height, self.max_views)
            feat = self.instance_feature(images, crops)
            results[iid] = feat
            log.append(f"instance {iid} class {name} tier {crops[0].tier}")
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                np.save(os.path.join(
                    save_dir, f"instance_{iid}_class_{name}_origin_view_mean.npy"),
                    feat)
        if save_dir is not None and log:
            with open(os.path.join(save_dir, "project_quality.txt"), "a") as f:
                f.write("\n".join(log) + "\n")
        return results
