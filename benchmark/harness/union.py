"""What the SGPN cell adds to the benchmark: each edge's union point cloud,
drawn from the seed, the FLOP counts of SGPN's layers, and a profile that
finds the relation encoder's kernels.

* ``union_clouds`` / ``make_unions``: for each ordered pair (i, j) of a
  scene (``harness.scenes``, its full directed graph in order), the points
  of every instance that lie in the pair's joint bounding box padded by
  ``pad``, 3DSSG's union cloud (Wald et al., CVPR 2020; the dataset
  settings of VL-SAT's config/mmgnet.json: 256 points).  The raw clouds
  are the scene's zero-meaned instance points plus their descriptor's
  centroid; the box is that of instances i and j; ``points`` of the points
  inside are drawn with replacement, zero-meaned, rounded to
  float16-representable values, and given a fourth channel: 1 on i's
  points, 2 on j's, 0 on the others'.  Vectorised per scene, the box tests
  on the card where there is one; float16 arrays (e, points, 4), which a
  float16 wire carries exactly.
* ``pointnet_flops`` / ``sgpn_flops``: the products of one PointNet row
  (2 P (C h1 + h1 h2 + h2 out)) and of SGPN over one scene, as the plain
  reference computes them.  ``pointnet_roofline.serve`` counts the
  PointNet FLOPs of the traced batches' valid rows and instances as three
  TF32 products, and ``mfu.serve`` reads ``sgpn_flops``.
* ``UnionProfile``: ``dgcnn.AllThreadsProfile`` whose ``summary["union"]``
  holds the device time of the kernels launched inside the program's
  ``model.union`` span (``dgcnn.span_device_time``); the summary holds no
  ``union`` where the program opens no such span.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Sequence

import numpy as np

from benchmark.harness.dgcnn import AllThreadsProfile, span_device_time
from benchmark.harness.trace import reduce_events
from benchmark.reference.sgpn import OBJ_WIDTHS, REL_WIDTHS

SPAN = "model.union"
HEAD = (512, 256)  # PointNetCls' and PointNetRelClsMulti's hidden widths


def union_clouds(scene: dict, rng: np.random.Generator, points: int = 256, pad: float = 0.2,
                 device=None) -> np.ndarray:
    """(e, points, 4) float16: the union cloud of each edge of
    ``scene["edge_index"]``, in its order.  The points inside each box are
    found on ``device`` (the host by default); the draws come from ``rng``
    and the arithmetic on the drawn points is the host's, so a seed gives
    the same clouds on any device."""
    import torch

    pts, desc, ei = scene["obj_points"], scene["descriptor"], scene["edge_index"]
    n, p = pts.shape[:2]
    flat = (pts + desc[:, None, :3]).reshape(n * p, 3)             # the raw clouds
    lo, hi = flat.reshape(n, p, 3).min(axis=1), flat.reshape(n, p, 3).max(axis=1)
    s, o = ei[:, 0], ei[:, 1]
    box = np.stack([np.minimum(lo[s], lo[o]) - np.float32(pad),
                    np.maximum(hi[s], hi[o]) + np.float32(pad)], axis=1)  # (e, 2, 3)
    x, box_t = (torch.from_numpy(a).to(device) for a in (flat, box))
    inside = ((x >= box_t[:, None, 0]) & (x <= box_t[:, None, 1])).all(dim=-1)  # (e, nP)
    counts = inside.sum(dim=1)                                     # >= 2P: i's and j's points
    members = inside.nonzero()[:, 1]                               # by edge, then point
    starts = counts.cumsum(0) - counts
    draw = torch.from_numpy(rng.random((len(ei), points))).to(device)
    pick = torch.minimum((draw * counts[:, None]).long(), counts[:, None] - 1)
    idx = members[starts[:, None] + pick].cpu().numpy()            # (e, points)
    xyz = flat[idx]
    xyz = xyz - xyz.mean(axis=1, keepdims=True)
    owner = idx // p
    mask = np.where(owner == s[:, None], 1, np.where(owner == o[:, None], 2, 0))
    return np.concatenate([xyz, mask[..., None]], axis=-1).astype(np.float16)


def make_unions(pool: Sequence[dict], seed: int, points: int = 256, pad: float = 0.2,
                device=None) -> List[np.ndarray]:
    """``union_clouds`` of every scene of ``pool``, drawn from ``seed``."""
    rng = np.random.Generator(np.random.PCG64([seed, 7]))
    return [union_clouds(s, rng, points, pad, device) for s in pool]


def pointnet_flops(points: int, channels: int, widths: Sequence[int]) -> int:
    """FLOPs of one PointNet row: three products over ``points`` points,
    ``channels`` -> widths[0] -> widths[1] -> widths[2]."""
    dims = (channels, *widths)
    return 2 * points * sum(a * b for a, b in zip(dims, dims[1:]))


def head_flops(in_size: int, classes: int) -> int:
    dims = (in_size, *HEAD, classes)
    return 2 * sum(a * b for a, b in zip(dims, dims[1:]))


def sgpn_flops(nodes: int, edges: int, cfg: dict) -> int:
    """FLOPs of SGPN over one scene of ``nodes`` instances and ``edges``
    union clouds, each layer once per row (the plain reference's count)."""
    per_node = (pointnet_flops(cfg["num_points"], 3, OBJ_WIDTHS)
                + head_flops(OBJ_WIDTHS[-1], cfg["num_obj_classes"]))
    per_edge = (pointnet_flops(cfg["num_points_union"], 4, REL_WIDTHS)
                + head_flops(REL_WIDTHS[-1], cfg["num_rel_classes"]))
    return nodes * per_node + edges * per_edge


class UnionProfile(AllThreadsProfile):
    """A profiled slice over every thread (``AllThreadsProfile``), with
    ``summary["union"]`` from ``span_device_time`` of ``model.union``."""

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = reduce_events(events, self.t1 - self.t0)
        union = span_device_time(events, name=SPAN)
        if union is not None:
            self.summary["union"] = union
