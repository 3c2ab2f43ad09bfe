"""Host-side profile of the port's evaluation path on one NVIDIA card.

    python tools/torch_eval_profile.py [--top 25]

Builds chip_smoke.py's full-width dual-branch MMGNet (fused PointNet, seed 0)
and its 5-9-node labelled split (256 scenes, B=32, buckets 8/12), runs
``eval.engine.evaluate`` once to warm up, then once under cProfile (the main
thread: dispatch of the forward and the rank functions, the copy-out and the
host assembly) and once plain, and prints the wall time of each, the main
thread's time by function (self and cumulative), and the share of the wall
spent in the engine's phases.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

PHASES = ("eval_step", "_metric_parts", "_pack", "_drain", "_assemble", "_unpack",
          "functional_call", "synchronize")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this profile needs a card")
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.step import make_eval_step

    cfg = MMGNetConfig(fused_pointnet=True)
    model = build_mmgnet(cfg, device="cuda", seed=chip_smoke.SEED)
    splits = chip_smoke.labelled_splits(chip_smoke.SEED + 2)
    batches = splits["val"]
    vocab = chip_smoke.triplet_vocab(batches)
    step = make_eval_step(model)
    state = model.state_dict()
    kw = dict(num_rel_classes=cfg.num_rel_classes, train_triplet_vocab=vocab, verbose=False,
              scene_recall=True)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        evaluate(step, state, batches, **kw)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    run()
    prof = cProfile.Profile()
    prof.enable()
    wall_prof = run()
    prof.disable()
    wall = run()
    scenes = sum(b.num_scenes for b in batches)
    print(f"{torch.cuda.get_device_name(0)}: {scenes} scenes in {len(batches)} batches; "
          f"wall {wall * 1e3:.1f} ms ({scenes / wall:.1f} scenes/s) plain, "
          f"{wall_prof * 1e3:.1f} ms under cProfile")
    stats = pstats.Stats(prof)
    by_name = {}
    for (_, _, name), (_, ncalls, tottime, cumtime, _) in stats.stats.items():
        t = by_name.setdefault(name, [0, 0.0, 0.0])
        t[0] += ncalls
        t[1] += tottime
        t[2] = max(t[2], cumtime)
    print("engine phases (main thread, cumulative ms per batch, share of the profiled wall):")
    for name in PHASES:
        if name in by_name:
            n, _, cum = by_name[name]
            print(f"  {name:<16} {cum * 1e3 / len(batches):8.2f} ms  {cum / wall_prof:6.1%}  "
                  f"({n} calls)")
    for key in ("tottime", "cumulative"):
        print(f"top {args.top} by {key}:")
        stats.sort_stats(key).print_stats(args.top)


if __name__ == "__main__":
    main()
