"""Check ``python -m vlsat_tpu_torch.main --data-parallel`` across the
visible cards against one process, on a synthetic 3DSSG-like split.

    python tools/torch_dp_cards.py [--launcher spawn|torchrun] [--ranks N]
                                   [--device cuda|cpu] [--work DIR]

It fabricates a split (``data.synthetic.make_synthetic_split``), packs it
with the port's pack tool, writes one experiment JSON at the default MODEL
width (B=8, one epoch, every step's loss logged, the streamed train path,
resident evaluation at B=16), then trains and evaluates it twice through
the CLI: in one process, and data-parallel -- ``spawn``: ``main
--data-parallel`` alone, which spawns one rank a visible card; ``torchrun``:
under ``python -m torch.distributed.run --standalone --nproc_per_node N``
(with ``--device cpu``, gloo ranks on the CPU).  It fails unless the first
three logged losses agree within 1e-5 relative, the data-parallel run's
closing validation equals its own ``--mode eval``, and rank 0 alone wrote
one checkpoint directory, one ``result.txt`` and one metric log; it prints
one JSON line with the wall times and the world.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def run(cmd: list, timeout: float) -> float:
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        sys.exit(f"{' '.join(cmd[:8])} ... exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return time.monotonic() - t0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--launcher", choices=["spawn", "torchrun"], default="spawn")
    p.add_argument("--ranks", type=int, default=0, help="torchrun: ranks (0 = one a card)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--work", default=str(REPO / ".chip_work" / "dp_cards"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from vlsat_tpu_torch.data.synthetic import make_synthetic_split

    ranks = args.ranks or torch.cuda.device_count()
    if args.launcher == "spawn" and (args.device != "cuda" or ranks < 2):
        sys.exit("--launcher spawn needs several cards (main spawns one rank a card)")
    work = Path(args.work)
    shutil.rmtree(work, ignore_errors=True)
    root, scans, cache = make_synthetic_split(str(work / "split"), num_scans=96,
                                              insts_per_scan=(4, 9), vertices_per_inst=400,
                                              rels_per_scan=8, seed=0)
    base = {"NAME": "Mmgnet", "SEED": 0, "MAX_EPOCHES": 1, "Batch_Size": 8, "LOG_INTERVAL": 1,
            "VALID_INTERVAL": 1, "TRAIN_MICROSTEPS": 1, "TRAIN_RESIDENT": False,
            "EVAL_BATCH_SIZE": 16, "EVAL_RESIDENT": True, "EVAL_GROUP": 2,
            "dataset": {"root": root, "scans_root": scans, "cache_root": cache,
                        "packed_root": str(work / "pack")}}
    paths = {}
    for name in ("one", "dp"):
        paths[name] = work / f"{name}.json"
        paths[name].write_text(json.dumps({**base, "PATH": str(work / name)}))
    py = [sys.executable]
    out = {"launcher": args.launcher, "ranks": ranks, "device": args.device,
           "pack_s": run(py + ["-m", "vlsat_tpu_torch.tools.pack_dataset", "--config",
                               str(paths["one"])], 900)}
    dev = ["--device", args.device]
    out["one_train_s"] = run(py + ["-m", "vlsat_tpu_torch.main", "--mode", "train", "--config",
                                   str(paths["one"])] + dev, 1800)
    launch = py + ["-m", "vlsat_tpu_torch.main"]
    if args.launcher == "torchrun":
        launch = py + ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                       str(ranks), "-m", "vlsat_tpu_torch.main"]
    dp = launch + ["--config", str(paths["dp"]), "--data-parallel"] + dev
    out["dp_train_s"] = run(dp + ["--mode", "train"], 1800)
    result = work / "dp" / "results" / "Mmgnet" / "default" / "result.txt"
    closing = result.read_text()
    out["dp_eval_s"] = run(dp + ["--mode", "eval"], 1800)
    if result.read_text() != closing:
        sys.exit("the data-parallel --mode eval metrics differ from its closing validation's")
    files = {n: sum(n in d or n in f for _, d, f in os.walk(work / "dp"))
             for n in ("checkpoints", "result.txt", "events.jsonl", "epoch_stats.jsonl")}
    if any(v != 1 for v in files.values()):
        sys.exit(f"want one of each, written by rank 0: {files}")
    losses = {}
    for name in ("one", "dp"):
        with open(work / name / "logs" / "Mmgnet" / "default" / "events.jsonl") as f:
            losses[name] = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
    if len(losses["one"]) < 3 or len(losses["dp"]) != len(losses["one"]) or not np.allclose(
            losses["dp"][:3], losses["one"][:3], rtol=1e-5, atol=0):
        sys.exit(f"first logged losses {losses['dp'][:3]} against {losses['one'][:3]}")
    rel = np.abs(np.subtract(losses["dp"], losses["one"])) / np.abs(losses["one"])
    out.update(steps=len(rel), first_losses=losses["dp"][:3], loss_rel_diff_max=float(rel.max()),
               metrics=sum(l.startswith("Eval: ") for l in closing.splitlines()), files=files)
    print(json.dumps(out))
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
