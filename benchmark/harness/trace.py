"""A profiled slice of the measured window, reduced in memory.

``Profile`` runs ``torch.profiler`` (host operators and the card's kernels,
copies and memsets) over a slice that the traffic generator opens and closes,
exports the recorded events as a Chrome trace under ``TMPDIR``, reads
them back and removes the file:

* device busy seconds: the union of the device intervals, so kernels that
  overlap on several streams count once;
* device time by name (the arithmetic of ``vlsat_tpu_torch/tools/
  trace_summary.py``: each device op's own duration, summed by name);
* the idle gaps between busy intervals, each named by what the host was
  doing at its midpoint: the innermost host operator or annotation that
  covers it, or the Python after the last one.

Host and device timestamps share the profiler's clock (microseconds in
the trace).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")
TOP = 10


def union_length(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total covered length of ``(start, end)`` intervals and the merged
    intervals, in start order."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def name_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]
              ) -> Dict[str, float]:
    """Seconds of idle gap by what the host was doing at each gap's
    midpoint: the innermost host operator or annotation that covers it, or,
    where none does (Python between operators), "python after" the last one
    that ended before it."""
    host = sorted(host)
    starts = [h[0] for h in host]
    by_end = sorted((h[1], h[2]) for h in host)
    ends = [e for e, _ in by_end]
    out: Dict[str, float] = defaultdict(float)
    active: List[Tuple[int, int, str]] = []
    nxt = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (s + e) // 2
        hi = bisect.bisect_right(starts, mid)
        active.extend(host[nxt:hi])
        nxt = max(nxt, hi)
        active = [h for h in active if h[1] >= mid]
        if active:
            label = min(active, key=lambda h: h[1] - h[0])[2]
        else:
            k = bisect.bisect_right(ends, mid)
            label = f"python after {by_end[k - 1][1]}" if k else "python"
        out[label] += (e - s) / 1e9
    return out


class Profile:
    """One profiled slice: ``start()`` / ``stop()`` around steady work;
    ``summary`` holds the reduction afterwards (None until then, and on a
    device without CUDA)."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self.t0 = self.t1 = None
        self.summary: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
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

    def contains(self, t: float) -> bool:
        """Whether host time ``t`` (``time.perf_counter``) lies in the slice."""
        return self.t0 is not None and self.t1 is not None and self.t0 <= t <= self.t1


def reduce_events(events, window_s: float) -> dict:
    """Busy seconds, device time by name and named idle gaps of Chrome-trace
    events (``ts`` and ``dur`` in microseconds, held as nanoseconds)."""
    dev: List[Tuple[int, int]] = []
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    host: List[Tuple[int, int, str]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = int(float(ev["ts"]) * 1e3)
        e = s + int(float(ev.get("dur", 0.0)) * 1e3)
        if ev.get("cat") in DEVICE_ACTIVITIES:
            dev.append((s, e))
            row = by_name[ev["name"]]
            row[0] += (e - s) / 1e9
            row[1] += 1
        elif ev.get("cat") in HOST_ACTIVITIES:
            host.append((s, e, ev["name"]))
    busy_ns, merged = union_length(dev)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    idle = name_gaps(gaps, host) if gaps else {}
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "kernels": {n: (v[0], v[1]) for n, v in by_name.items()},
        "device_ops": [[n, v[0]] for n, v in top_ops],
        "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }
