"""Find the knee of a serving cell: the highest offered rate the program
sustains with no backlog growing through the window.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds 6 \\
        --rates 1000 1500 2000 ... [--out out/knee.json]

One process sets the cell's server up once (``traffic/serve_open_loop.py``
``Session``) and offers each rate in turn for ``--seconds``, open loop, as
the cell does.  A rate keeps up when no request failed, the 95th
percentile of the window's last third is at most 1.5 times that of its
first third plus 10 ms (a growing queue lifts the late requests'
latencies), and the requests still unanswered at the close are at most what
twice the first third's 95th percentile holds in flight at that rate.  The
knee is the highest rate that keeps up with every lower rate keeping up
too.  The cell's file then takes the knee
and a rate of about four fifths of it, by hand.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def row(w: dict, rate: float, seconds: float) -> dict:
    import numpy as np

    lat, due = w["latencies_ms"], w["due"]
    first, last = lat[due < seconds / 3], lat[due >= 2 * seconds / 3]
    p95 = lambda a: float(np.percentile(a, 95)) if len(a) else float("nan")
    out = {"rate": rate, "answered_per_s": w["answered_in_window"] / seconds,
           "p50_ms": float(np.percentile(lat, 50)), "p95_ms": p95(lat),
           "p95_first_third_ms": p95(first), "p95_last_third_ms": p95(last),
           "backlog_at_close": w["backlog"], "failed": int((~w["answered"]).sum()),
           "batches": w["batches"], "fill": w["fill"], "late_ms_p99": w["late_ms_p99"]}
    early = out["p95_first_third_ms"]
    out["keeps_up"] = bool(out["failed"] == 0 and out["p95_last_third_ms"] <= 1.5 * early + 10
                           and out["backlog_at_close"] <= rate * 2e-3 * early)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import core, program

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    cell = core.load_cell(args.workload)
    ctx = core.Context(cell=cell, config=core.load_config(cell["config"]), seed=args.seed,
                       seconds=args.seconds, trace=False, device=dev, t_process=time.perf_counter())
    gen = core.load_generator(cell["generator"])
    sess = gen.Session(ctx)
    rows = []
    for k, rate in enumerate(sorted(args.rates)):
        rows.append(row(sess.offer(rate, args.seconds, args.seed + k), rate, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    sess.server.stop()
    knee = None
    for r in rows:
        if not r["keeps_up"]:
            break
        knee = r["rate"]
    result = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
              "knee": knee, "rows": rows, "device": torch.cuda.get_device_name(dev),
              "power_limit": program.power_limit(dev)}
    print(json.dumps({"knee": knee, "device": result["device"],
                      "power_limit": result["power_limit"]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
