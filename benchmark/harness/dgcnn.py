"""What the SGGpoint cell measures of its DGCNN backbone.

* ``AllThreadsProfile``: ``trace.Profile`` over every thread of the process
  (``torch.profiler`` with ``profile_all_threads``), so that the server's
  worker thread, which launches every kernel, is recorded with its
  annotations; ``summary["dgcnn"]`` holds the device time of the kernels
  launched inside the program's ``model.dgcnn`` span
  (``span_device_time``).  Where the profiler cannot record other threads,
  or the program opens no such span, the summary holds no ``dgcnn``.
* ``dgcnn_factored_flops``: the FLOPs of one instance's DGCNN in its
  factored form, the least any implementation of the same function needs,
  which the roofline and MFU readers divide by the fp32-accurate peak.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import DEVICE_ACTIVITIES, Profile, reduce_events

SPAN = "model.dgcnn"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
STAGES = (64, 64, 128, 256)  # the EdgeConv widths (reference/sggpoint.py)


def _ns(ev, key: str = "ts") -> int:
    return int(float(ev[key]) * 1e3)


def span_device_time(events, name: str = SPAN) -> Optional[Dict[str, float]]:
    """Device seconds of the kernels, copies and memsets whose launch (the
    runtime or driver call of the same ``correlation``) lies inside a host
    annotation ``name`` on the launching thread, and the count of such
    annotations; None where the trace holds no annotation ``name``."""
    spans: Dict[object, List[Tuple[int, int]]] = defaultdict(list)
    launches: Dict[int, Tuple[object, int]] = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat == "user_annotation" and ev.get("name") == name:
            s = _ns(ev)
            spans[ev.get("tid")].append((s, s + _ns(ev, "dur")))
        elif cat in LAUNCH_CATEGORIES and "correlation" in ev.get("args", {}):
            launches[int(ev["args"]["correlation"])] = (ev.get("tid"), _ns(ev))
        elif cat in DEVICE_ACTIVITIES and "correlation" in ev.get("args", {}):
            device.append((int(ev["args"]["correlation"]), _ns(ev, "dur")))
    if not spans:
        return None
    starts = {tid: [s for s, _ in sorted(v)] for tid, v in spans.items()}
    ends = {tid: [e for _, e in sorted(v)] for tid, v in spans.items()}
    total_ns = 0
    for corr, dur in device:
        tid, t = launches.get(corr, (None, None))
        if tid not in starts:
            continue
        i = bisect.bisect_right(starts[tid], t) - 1
        if i >= 0 and t <= ends[tid][i]:
            total_ns += dur
    return {"spans": sum(len(v) for v in spans.values()), "seconds": total_ns / 1e9}


class AllThreadsProfile(Profile):
    """A profiled slice over every thread (``start()`` / ``stop()`` as
    ``trace.Profile``), with ``summary["dgcnn"]`` from
    ``span_device_time`` where the trace has the annotations."""

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        except (AttributeError, TypeError):  # a torch without it: this thread alone
            config = None
        return profile(activities=acts, experimental_config=config)

    def warm(self) -> None:
        """Start and stop one throwaway session, in set-up: a process's
        first profiler session takes seconds to start, which inside the
        window would stall the traffic and leave the slice empty."""
        prof = self._profile()
        prof.start()
        prof.stop()

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.start()
        self.t0 = time.perf_counter()

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
        dgcnn = span_device_time(events)
        if dgcnn is not None:
            self.summary["dgcnn"] = dgcnn


def dgcnn_factored_flops(points: int, point_channels: int = 3, embeddings: int = 768
                         ) -> Tuple[int, Dict[str, int]]:
    """FLOPs of one instance's DGCNN in its factored form: per EdgeConv
    stage the kNN Gram (2 P^2 C_in) and one projection of each point by
    [W1 | W2 - W1] (2 P C_in 2 C_out: the 1x1 convolution of
    [x_j - x_i, x_i] is x_j W1 + x_i (W2 - W1), gathered after the product,
    so it needs no product per neighbour), then ``conv5`` (2 P 512
    embeddings).  The max over k, BatchNorm and LeakyReLU are not counted.
    The original form costs k times the projections (2 P k 2 C_in C_out a
    stage): 463 MFLOP against 23 at P = 128, k = 20."""
    parts = {"gram": 0, "project": 0}
    cin = point_channels
    for out in STAGES:
        parts["gram"] += 2 * points * points * cin
        parts["project"] += 2 * points * cin * 2 * out
        cin = out
    parts["conv5"] = 2 * points * sum(STAGES) * embeddings
    return sum(parts.values()), parts
