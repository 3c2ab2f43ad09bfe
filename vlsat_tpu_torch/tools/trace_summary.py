"""Summarize a Chrome trace of ``utils.profiling.trace()``: device time by
kernel and by category (the port's twin of ``tools/xplane_summary.py``):

    VLSAT_PROFILE_DIR=prof python -m vlsat_tpu_torch.tools.bench   # capture
    python -m vlsat_tpu_torch.tools.trace_summary prof [--iters 32] [--top 25]
        [--cat kernel]

``path`` is a trace file or a directory (its newest ``*.json``).  The
events summed are those of ``--cat``: ``kernel`` (the default) takes the
card's kernels, copies and memsets; ``cpu_op`` takes the host's operators,
which is what a CPU run records.  Operators nest, so each event counts its
own time less that of the events inside it on its thread, and the
categories sum to the total.  ``--iters`` divides every time by the calls
the capture covers, so the numbers read as microseconds a call.

Categories come from the names: the port's ``vlsat`` kernels (segment-max,
PointNet), GEMMs, softmax, elementwise, reductions, copies, and the rest.
``main(argv)`` returns the summary it prints.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CATEGORIES = (
    ("vlsat segment-max / PointNet", r"segment_max|pointnet"),
    ("copies", r"(?i:memcpy|memset)|copy|CatArray|aten::(cat|to|_to_copy|clone|contiguous|"
               r"index_select|gather|take)\b"),
    ("softmax", r"softmax|SoftMax"),
    ("GEMMs", r"gemm|gemv|cutlass|xmma|cublas|aten::(mm|bmm|addmm|baddbmm|matmul|linear)\b"),
    ("reductions", r"reduce_kernel|reduction|aten::(sum|mean|amax|amin|max|min|argmax|"
                   r"argmin|norm|linalg_vector_norm|prod|all|any|var|std)\b"),
    ("elementwise", r"elementwise|aten::(add|sub|rsub|mul|div|neg|relu|threshold|exp|log|"
                    r"sqrt|rsqrt|pow|where|clamp|maximum|minimum|sigmoid|tanh|abs|eq|ne|"
                    r"lt|le|gt|ge|logical_\w+|bitwise_\w+|fill|zero|masked_fill|addcmul|"
                    r"addcdiv|lerp)_?\b"),
)
OTHER = "other"


def categorize(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return OTHER


def trace_path(path: str) -> str:
    if os.path.isdir(path):
        paths = glob.glob(os.path.join(path, "*.json"))
        if not paths:
            raise SystemExit(f"no Chrome trace (*.json) under {path}")
        return max(paths, key=os.path.getmtime)
    return path


def self_times(events: list) -> list:
    """(name, microseconds) of each event less the events nested inside it
    on its (pid, tid)."""
    by_thread = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        self_us = [float(e.get("dur", 0.0)) for e in evs]
        stack = []  # (end, index) of the open enclosing events
        for i, e in enumerate(evs):
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            while stack and (stack[-1][0] <= ts or ts + dur > stack[-1][0] + 1e-3):
                stack.pop()  # ended before e, or overlaps it without enclosing it
            if stack:
                self_us[stack[-1][1]] -= dur
            stack.append((ts + dur, i))
        out.extend((e["name"], max(t, 0.0)) for e, t in zip(evs, self_us))
    return out


def summarize(path: str, iters: int = 1, top: int = 25, cat: str = "kernel") -> dict:
    with open(trace_path(path)) as f:
        events = json.load(f)["traceEvents"]
    cats = DEVICE_CATS if cat == "kernel" else (cat,)
    chosen = [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]
    per_name = defaultdict(float)
    calls = defaultdict(int)
    per_cat = defaultdict(float)
    for name, us in self_times(chosen):
        per_name[name] += us / iters
        calls[name] += 1
        per_cat[categorize(name)] += us / iters
    return {
        "trace": trace_path(path), "events": cat, "iters": iters,
        "total_us": sum(per_cat.values()),
        "categories": dict(sorted(per_cat.items(), key=lambda kv: -kv[1])),
        "top": [{"name": n, "us": us, "calls": calls[n], "category": categorize(n)}
                for n, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="a Chrome trace, or a directory of them (the newest)")
    ap.add_argument("--iters", type=int, default=1,
                    help="calls the capture covers (divides every time)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--cat", type=str, default="kernel",
                    help="kernel (the card's kernels, copies, memsets) or a trace "
                         "category such as cpu_op")
    args = ap.parse_args(argv)
    res = summarize(args.path, iters=args.iters, top=args.top, cat=args.cat)
    print(f"{res['trace']}: {res['total_us']:.1f} us/call of {args.cat} time")
    print("\ncategories:")
    for k, v in res["categories"].items():
        print(f"  {v:11.1f} us/call  {k}")
    print(f"\ntop {args.top}:")
    for row in res["top"]:
        print(f"  {row['us']:11.1f} us/call  {row['calls']:6d}x  {row['name'][:100]}")
    return res


if __name__ == "__main__":
    main()
