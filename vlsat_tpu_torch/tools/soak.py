"""Full-scale soak (the port's twin of ``tools/soak.py``): run the trainer
the way the reference is run, through a crash.

The reference trains for 100 epochs at the full 1,177-scan 3DSSG scale with
validation interleaved and checkpoints promoted (src/model/model.py:84-166).
This tool:

  1. synthesizes a full-scale split (default 1,177 scans, 5-9 objects
     each, the real scan-split histogram) and packs it
     (``data.synthetic.make_synthetic_split``, ``data.packed.pack_scenes``);
  2. phase A: launches ``python -m vlsat_tpu_torch.main --mode train`` as a
     child process and SIGKILLs it 2 s after the target epoch starts: a
     real crash, not a polite shutdown;
  3. phase B: relaunches the same command; the runner's tolerant load
     restores the latest checkpoint and resumes;
  4. collects the per-epoch telemetry (the runner's ``epoch_stats.jsonl``:
     wall s, scenes/s, peak RSS, the card's memory, the validation
     trajectory), checks the resume point and, given a bench capture with
     link-cost models (``--bench``), compares the steady train rate with
     the model's prediction.

Writes ``SOAK_torch.json`` (``--out``).

Usage:
    python -m vlsat_tpu_torch.tools.soak [--num-scans 1177] [--epochs 20]
        [--kill-epoch 12] [--valid-interval 5] [--batch-size 8]
        [--base DIR] [--bench BENCH.json] [--out SOAK_torch.json] [--keep]
        [--device cpu]

The parent never touches the card (the child owns it): it synthesizes and
packs the split on the CPU.  ``--base`` defaults to ``vlsat_torch_soak``
in the temporary directory (``TMPDIR``, else ``/tmp``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KILL_DELAY_S = 2.0  # let the epoch get underway, so that the kill lands mid-epoch


def predict_rate(model: dict, rtt_ms: float, h2d_MBps: float,
                 d2h_MBps: float | None = None) -> float:
    """Scenes/s a link-cost model predicts at a given link state (the
    formula of ``bench.py``'s ``predict_rate``):

    t_unit(link) = t_nolink + n_rtt*rtt + h2d_bytes/bw_h2d + d2h_bytes/bw_d2h

    ``d2h_MBps`` defaults to ``h2d_MBps``."""
    d2h = d2h_MBps if d2h_MBps else h2d_MBps
    t = (model["t_nolink_s"] + model["n_rtt"] * rtt_ms / 1e3
         + model["h2d_bytes"] / max(h2d_MBps * 1e6, 1.0)
         + model["d2h_bytes"] / max(d2h * 1e6, 1.0))
    return model["unit_scenes"] / max(t, 1e-9)


def build_dataset(base: str, num_scans: int, seed: int = 11) -> dict:
    """Synthesize the split (the JAX tool's draws) and pack its train and
    validation halves, on the CPU."""
    from vlsat_tpu_torch.data.dataset import SSGScenes
    from vlsat_tpu_torch.data.packed import pack_scenes
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split

    rng = np.random.RandomState(seed)
    node_counts = rng.randint(5, 10, num_scans)          # scan-split histogram
    rel_counts = np.clip(rng.poisson(17, num_scans), 1, 46)
    root, scans_root, cache = make_synthetic_split(
        base, num_scans=num_scans, node_counts=node_counts, rel_counts=rel_counts,
        vertices_per_inst=2000, seed=seed)
    t0 = time.perf_counter()
    for split, drop in (("train", True), ("validation", False)):
        ds = SSGScenes(root=root, scans_root=scans_root, split=f"{split}_scans",
                       num_points=128, feat_dim=512, multi_rel=True, cache_root=cache)
        pack_scenes(ds, os.path.join(base, "packed", split), seed=2020,
                    drop_relation_free=drop)
    return {"root": root, "scans_root": scans_root, "cache": cache,
            "packed_root": os.path.join(base, "packed"),
            "pack_s": round(time.perf_counter() - t0, 1)}


def launch_train(cfg_path: str, log_path: str, device: str) -> subprocess.Popen:
    with open(log_path, "a") as f:  # the child keeps its own handle
        return subprocess.Popen(
            [sys.executable, "-m", "vlsat_tpu_torch.main", "--mode", "train",
             "--config", cfg_path, "--exp", "soak", "--device", device],
            stdout=f, stderr=subprocess.STDOUT, cwd=REPO,
            env={**os.environ, "PYTHONUNBUFFERED": "1"})


def watch_for_epoch(log_path: str, epoch: int, proc: subprocess.Popen,
                    timeout_s: float) -> bool:
    """Block until 'Training epoch: {epoch}' appears in the child's log
    (True) or the child exits / times out (False)."""
    needle = f"Training epoch: {epoch}"
    deadline = time.monotonic() + timeout_s
    pos = 0
    while time.monotonic() < deadline:
        if os.path.exists(log_path):
            with open(log_path) as f:
                f.seek(pos)
                chunk = f.read()
                pos = f.tell()
            if needle in chunk:
                return True
        if proc.poll() is not None:
            return False
        time.sleep(1.0)
    return False


def _read_stats(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-scans", type=int, default=1177)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--kill-epoch", type=int, default=12)
    ap.add_argument("--valid-interval", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--base", type=str,
                    default=os.path.join(tempfile.gettempdir(), "vlsat_torch_soak"))
    ap.add_argument("--bench", type=str, default=None,
                    help="bench JSON with link_cost_models: the in-situ steady train rate "
                         "is compared to the model")
    ap.add_argument("--out", type=str, default="SOAK_torch.json")
    ap.add_argument("--timeout", type=float, default=7200)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the child's torch device (the card by default)")
    args = ap.parse_args(argv)

    res = {"num_scans": args.num_scans, "epochs": args.epochs,
           "kill_epoch": args.kill_epoch, "valid_interval": args.valid_interval,
           "batch_size": args.batch_size}

    print("building full-scale dataset + packs ...", flush=True)
    t0 = time.perf_counter()
    ds = build_dataset(args.base, args.num_scans)
    res["dataset_build_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(ds), flush=True)

    exp_root = os.path.join(args.base, "exp")
    shutil.rmtree(exp_root, ignore_errors=True)
    cfg = {
        "NAME": "Mmgnet", "PATH": exp_root,
        "MAX_EPOCHES": args.epochs, "VALID_INTERVAL": args.valid_interval,
        "Batch_Size": args.batch_size, "LOG_INTERVAL": 100,
        "EVAL_BATCH_SIZE": "auto",  # the per-bucket eval batch table
        "dataset": {"root": ds["root"], "scans_root": ds["scans_root"],
                    "cache_root": ds["cache"], "packed_root": ds["packed_root"]},
    }
    cfg_path = os.path.join(args.base, "soak_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    stats_path = os.path.join(exp_root, "Mmgnet", "soak", "epoch_stats.jsonl")
    log_path = os.path.join(args.base, "train.log")
    if os.path.exists(log_path):
        os.remove(log_path)

    # ---- phase A: train until kill_epoch starts, then SIGKILL ----------
    print(f"phase A: training to epoch {args.kill_epoch}, then SIGKILL", flush=True)
    t0 = time.perf_counter()
    proc = launch_train(cfg_path, log_path, args.device)
    if not watch_for_epoch(log_path, args.kill_epoch, proc, args.timeout):
        proc.kill()
        rc = proc.wait()
        raise SystemExit(f"phase A never reached epoch {args.kill_epoch} "
                         f"(child rc={rc}); see {log_path}")
    time.sleep(KILL_DELAY_S)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    res["phase_a_wall_s"] = round(time.perf_counter() - t0, 1)
    res["killed_at_epoch"] = args.kill_epoch
    epochs_a = _read_stats(stats_path)
    res["phase_a_epochs"] = len(epochs_a)

    # ---- phase B: relaunch; the tolerant load resumes from the latest ckpt
    print("phase B: relaunch + resume", flush=True)
    t0 = time.perf_counter()
    proc = launch_train(cfg_path, log_path, args.device)
    try:
        rc = proc.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    res["phase_b_wall_s"] = round(time.perf_counter() - t0, 1)
    res["phase_b_rc"] = rc
    if rc != 0:
        raise SystemExit(f"phase B exited rc={rc}; see {log_path}")

    epochs_all = _read_stats(stats_path)
    epochs_b = epochs_all[len(epochs_a):]
    res["resume_epoch"] = epochs_b[0]["epoch"] if epochs_b else None
    res["resumed_within_one_epoch_of_kill"] = (
        epochs_b != [] and abs(epochs_b[0]["epoch"] - args.kill_epoch) <= 1)
    res["final_epoch"] = epochs_all[-1]["epoch"] if epochs_all else None
    res["epoch_stats"] = epochs_all
    res["val_trajectory"] = [
        {"epoch": e["epoch"], "mean_recall_50": e["mean_recall_50"]}
        for e in epochs_all if "mean_recall_50" in e]
    res["peak_rss_mb"] = max(e.get("peak_rss_mb", 0) for e in epochs_all)
    res["peak_hbm_mb"] = max(e.get("hbm_peak_mb", 0) for e in epochs_all)
    # steady in-situ train rate: median of the non-validation epochs after
    # the first (warm-up) epoch of each phase
    first_b = epochs_b[0] if epochs_b else None
    steady = [e["scenes_per_sec"] for e in epochs_all[1:]
              if "mean_recall_50" not in e and e is not first_b]
    res["steady_train_scenes_per_sec"] = (
        round(float(np.median(steady)), 1) if steady else None)

    # ---- compare against the bench link-cost model ----------------------
    if args.bench and res["steady_train_scenes_per_sec"]:
        try:
            with open(args.bench) as f:
                b = json.load(f)
            b = b.get("parsed", b)
            m = b["link_cost_models"]["train_e2e_scenes_per_sec"]
            lk = m["link"]
            pred = predict_rate(m, lk["rtt_ms"], lk["h2d_MBps"], lk.get("d2h_MBps"))
            res["bench_model_prediction"] = {
                "predicted_scenes_per_sec": round(pred, 1),
                "at_link": lk,
                "in_situ_over_predicted": round(
                    res["steady_train_scenes_per_sec"] / pred, 3),
                "note": ("in-situ epochs include host-side logging/progbar "
                         "and epoch boundaries the bench band does not"),
            }
        except Exception as e:  # noqa: BLE001 -- the comparison is best-effort
            res["bench_model_prediction"] = {"error": str(e)[:200]}

    print(json.dumps(res, indent=1), flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")
    if not args.keep:
        shutil.rmtree(args.base, ignore_errors=True)
    return res


if __name__ == "__main__":
    main()
