"""Per-batch resident evaluation against the K-batch grouped loader (the
port's twin of ``tools/bench_grouped_eval.py``):

    python -m vlsat_tpu_torch.tools.bench_grouped_eval [--scene-recall]
        [--reps 5] [--device cpu]

Full ``evaluate()`` passes (the whole metric suite) over ``tools.bench``'s
512-scene bucket-16 split, fed by ``ResidentEvalLoader`` (one packed output
copy a batch) and by ``ResidentGroupedEval`` at K = 4, 8 and 16 (one copy a
group): scenes/s, the median of ``--reps`` passes after a warm pass.

Each grouped run's metrics are held against the per-batch run's.  On the
CPU they must be equal, as the JAX tool asserts.  On the card a padded tail
row can flip a rank tie, so there the grouped run's saved rank lists are
compared with the per-batch run's and every mismatch is counted
(``rank_mismatches``, of ``ranks``): more than 0.1 % fails, the gate of
``chip_smoke.py``'s data-feed phase.  ``main(argv)`` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

GROUPS = (4, 8, 16)
EVAL_B = 32
RANK_GATE = 1e-3  # the largest share of rank-list entries that may differ on the card
RANK_FILES = ("topk_pred_list", "topk_triplet_list", "cls_matrix_list")


def rank_lists(save_dir: str) -> dict:
    """The rank lists ``evaluate(save_dir=...)`` wrote."""
    return {name: np.load(os.path.join(save_dir, f"{name}.npy")) for name in RANK_FILES}


def rank_mismatches(got: dict, want: dict) -> tuple:
    """(differing entries, entries) over the rank lists of two runs."""
    if sorted(got) != sorted(want):
        raise ValueError(f"rank lists {sorted(got)} against {sorted(want)}")
    bad = total = 0
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:
            raise ValueError(f"{name}: shape {g.shape} against {w.shape}")
        bad += int((g != w).sum())
        total += int(w.size)
    return bad, total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene-recall", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (the card by default; cpu for smoke tests)")
    args = ap.parse_args(argv)

    from vlsat_tpu_torch.data.resident import (ResidentEvalLoader, ResidentGroupedEval,
                                               ResidentScenes)
    from vlsat_tpu_torch.device import resolve_device
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import build_mmgnet
    from vlsat_tpu_torch.tools import bench
    from vlsat_tpu_torch.train.step import make_eval_step

    dev = resolve_device(args.device)
    base = os.environ.get("VLSAT_BENCH_SPLIT",
                          os.path.join(tempfile.gettempdir(), "vlsat_torch_bench_split"))
    packed = bench.split_pack(base, 9, num_scans=bench.SPLIT_SCANS,
                              insts_per_scan=bench.SPLIT_INSTS,
                              vertices_per_inst=bench.VERTS_PER_INST, rels_per_scan=12, seed=0)
    model = build_mmgnet(bench.model_config(), dev, seed=0)
    state = model.state_dict()
    eval_fn = make_eval_step(model, device=dev)
    resident = ResidentScenes(packed, device=dev)
    work = tempfile.mkdtemp(prefix="vlsat_grouped_")

    def run(loader, tag):
        save = os.path.join(work, tag)
        m = evaluate(eval_fn, state, loader, verbose=False, scene_recall=args.scene_recall,
                     save_dir=save)  # warm
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            evaluate(eval_fn, state, loader, verbose=False, scene_recall=args.scene_recall)
            ts.append(time.perf_counter() - t0)
        return len(packed) / float(np.median(ts)), m, rank_lists(save)

    try:
        base_rate, base_m, base_ranks = run(ResidentEvalLoader(resident, EVAL_B), "per_batch")
        rows = [{"loader": "per_batch", "group": 1, "scenes_per_sec": base_rate}]
        print(f"per-batch resident (B={EVAL_B}): {base_rate:8.1f} scenes/s", flush=True)
        for g in GROUPS:
            rate, m, ranks = run(ResidentGroupedEval(resident, EVAL_B, group=g), f"k{g}")
            row = {"loader": "grouped", "group": g, "scenes_per_sec": rate,
                   "speedup": rate / base_rate}
            if dev.type == "cuda":
                bad, total = rank_mismatches(ranks, base_ranks)
                row.update(rank_mismatches=bad, ranks=total)
                if bad > RANK_GATE * total:
                    raise RuntimeError(f"K={g}: {bad} of {total} rank-list entries differ "
                                         "from the per-batch run's")
                note = f"{bad} of {total} rank-list entries differ"
            else:
                for k in base_m:
                    np.testing.assert_array_equal(np.asarray(base_m[k]), np.asarray(m[k]),
                                                  err_msg=k)
                row["metrics_equal"] = True
                note = "metrics identical"
            rows.append(row)
            print(f"grouped K={g:<2} (B={EVAL_B}):      {rate:8.1f} scenes/s "
                  f"({rate / base_rate:.2f}x, {note})", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res = {"scenes": len(packed), "scene_recall": args.scene_recall, "rows": rows,
           "metrics": base_m}
    print(json.dumps({"grouped_eval": rows}), flush=True)
    return res


if __name__ == "__main__":
    main()
