"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``vlsat_tpu_torch``).  The cell's file, configuration,
traffic generator and metric readers are found by name (``harness/core.py``).
With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled slice of the
window.  The compared numbers and their limits are the last lines on
standard error and the last key of the line.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and 3
when JAX or the JAX package was loaded; both print no result.  Build and
kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def main(argv=None, device=None, overrides=None, spec=None) -> int:
    """One run.  ``device`` skips the look for a card (the CPU tests pass
    ``torch.device("cpu")``); ``overrides`` replaces keys of the cell's
    ``config`` and ``params`` (the tests narrow the model and the window);
    ``spec`` stands in for ``BENCHMARK.json`` (the tests run a cell that it
    does not list)."""
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    _caches()
    from benchmark.harness import core

    spec = spec or core.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        print(f"{args.workload}: the cell file and BENCHMARK.json disagree", file=sys.stderr)
        return 2

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.init()
    config = core.load_config(cell["config"])
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    cell["params"].update(overrides.get("params", {}))
    cell["limits"].update(overrides.get("limits", {}))
    ctx = core.Context(cell=cell, config=config, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=device, t_process=T_PROCESS)
    ctx.mark(f"torch {torch.__version__} imported, {device} ready")
    obs = core.load_generator(cell["generator"]).run(ctx)
    gc.unfreeze()  # the generator froze its set-up's objects (harness/program.py settle)

    bad = core.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in core.cell_metrics(spec, args.workload, kind):
        value = core.load_reader(m["name"]).read(obs, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(entry["chips"]),
           "memory_peak_bytes": int(obs["memory_peak_bytes"])}
    if args.trace and obs.get("trace"):
        dev["busy_s"] = obs["trace"]["busy_s"]
        dev["window_s"] = obs["trace"]["window_s"]
    if obs.get("power_limit"):
        dev["power_limit"] = obs["power_limit"]
    line = core.result_line(obs, metrics, dev, bool(args.trace))
    for c in obs["checks"]:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check failed requests: {obs['failed']} limit 0", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
