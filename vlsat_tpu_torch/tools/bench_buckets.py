"""Per-bucket table of evaluation and training on the card (the port's twin
of ``tools/bench_buckets.py``):

    python -m vlsat_tpu_torch.tools.bench_buckets [--buckets 8 12 16 24 32 48 64]
        [--batch-sizes 4 8 16 32 64] [--train-batch-sizes ...] [--reps 3]
        [--out bucket_table.json] [--device cpu]

For each node bucket and batch size, with scenes filling 80-100 % of the
bucket (the full-width ``MMGNetConfig()``):

* eval: the per-batch program the metric engine runs (the dual-branch
  forward, every rank function of ``eval.engine._metric_parts`` and the D2H
  pack of ``_pack``): ms a batch, its IQR, scenes/s, GFLOP and MFU;
* train: the whole step of ``train.step.make_train_step`` (forward, loss,
  backward, AdamW): the same columns.

A cell that runs out of card memory is reported as ``"oom"``
(``eval_error`` / ``train_error``), the cache emptied and the peak reset
before the next.  A cell whose MFU is more than 2x out of its family (the
other cells of its mode and bucket) is measured again once, and marked
``*_remeasured`` or, if it stays out, ``*_outlier``.

The row keys are the JAX tool's.  Their card meaning:

* ``*_ms``, ``*_ms_iqr``: median and IQR over ``--reps`` spans of N
  back-to-back calls between two CUDA events, after a warm-up call (XLA's
  two-trip-count slope has nothing to defeat in eager PyTorch);
* ``*_slope_n_hi``: N, the calls in each span, widened until a span takes
  at least ``MIN_SPAN_S``;
* ``*_gflops``: ``utils.profiling.compiled_flops`` of one call;
  ``*_gflops_standalone``: the same count over a second call on its own.
  They differ only if the work depends on the call; ``*_dce_suspect``
  (their ratio) appears when they differ by more than 10 %;
* ``*_mfu``: GFLOP over the time against ``peak_flops_per_sec``, the H100's
  dense bf16 peak (the model runs fp32, TF32 off); None on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

MIN_SPAN_S = 0.2   # the shortest timed span of back-to-back calls
N_MIN, N_MAX = 4, 512
GT_CAP = 3         # the GT slots the JAX tool's pack ships


def scene_counts(bucket: int, b: int) -> tuple:
    """Realistic occupancy: scenes fill 80-100 % of their bucket."""
    lo = max(2, int(bucket * 0.8))
    return tuple((lo + i % max(bucket - lo + 1, 1)) for i in range(b))


def scene_batch(seed: int, bucket: int, b: int, with_text: bool = False):
    from vlsat_tpu_torch.data.synthetic import make_batch

    return make_batch(seed=seed, node_counts=scene_counts(bucket, b), num_points=128,
                      bucket=bucket, with_text=with_text)


def is_oom(err: BaseException) -> bool:
    return isinstance(err, torch.cuda.OutOfMemoryError) or "out of memory" in str(err)


def adaptive_time(fn, dev, reps: int) -> tuple:
    """(median s, IQR s, N) over ``reps`` spans of N calls, N widened from a
    first estimate until a span takes ``MIN_SPAN_S``."""
    from vlsat_tpu_torch.tools.bench import span_s, sync

    fn()
    sync(dev)
    per0 = max(span_s(fn, N_MIN, dev) / N_MIN, 1e-7)
    n = min(max(N_MIN, math.ceil(MIN_SPAN_S / per0)), N_MAX)
    vals = [span_s(fn, n, dev) / n for _ in range(reps)]
    return (float(np.median(vals)), float(np.subtract(*np.percentile(vals, [75, 25]))), n)


class Cells:
    """The eval and train cells of one model on ``dev``."""

    def __init__(self, dev, reps: int = 3, cfg=None):
        from vlsat_tpu_torch.eval.engine import _metric_parts, _pack
        from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
        from vlsat_tpu_torch.train.optim import make_optimizer
        from vlsat_tpu_torch.train.step import make_eval_step
        from vlsat_tpu_torch.utils.profiling import peak_flops_per_sec

        cfg = cfg or MMGNetConfig()
        self.dev, self.reps, self.cfg = dev, reps, cfg
        self.peak = peak_flops_per_sec(dev) if dev.type == "cuda" else None
        model = build_mmgnet(cfg, dev, seed=0)
        state = model.state_dict()
        step = make_eval_step(model, device=dev)

        def program(batch):
            out = step(state, batch)
            return _pack(_metric_parts(out, batch, single_label=False, with_scores=False,
                                       scene_recall=False, gt_cap=GT_CAP))

        self.program = program
        self.opt = make_optimizer(lr=1e-4, max_iteration=1000)
        self.train_model = build_mmgnet(cfg, dev, seed=0)

    def _cell(self, row: dict, mode: str, fn, b: int) -> dict:
        from vlsat_tpu_torch.utils.profiling import compiled_flops

        per, iqr, n = adaptive_time(fn, self.dev, self.reps)
        fl = compiled_flops(fn)
        fl_alone = compiled_flops(fn)
        row.update({f"{mode}_ms": round(per * 1e3, 3),
                    f"{mode}_ms_iqr": round(iqr * 1e3, 3),
                    f"{mode}_slope_n_hi": n,
                    f"{mode}_scenes_per_sec": round(b / per, 1),
                    f"{mode}_gflops": round(fl / 1e9, 1),
                    f"{mode}_gflops_standalone": round(fl_alone / 1e9, 1),
                    f"{mode}_mfu": round(fl / per / self.peak, 4) if self.peak else None})
        if fl_alone and abs(fl / fl_alone - 1.0) > 0.1:
            row[f"{mode}_dce_suspect"] = round(fl / fl_alone, 3)
        return row

    def _guard(self, row: dict, mode: str, measure) -> dict:
        try:
            measure()
        except Exception as e:  # noqa: BLE001 -- a cell's failure is its row's result
            row[f"{mode}_error"] = "oom" if is_oom(e) else str(e)[:200]
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        return row

    def measure_eval(self, bucket: int, b: int) -> dict:
        row = {"bucket": bucket, "batch": b, "edges": bucket * (bucket - 1)}

        def measure():
            batch = scene_batch(0, bucket, b).to(self.dev)
            self._cell(row, "eval", lambda: self.program(batch), b)

        return self._guard(row, "eval", measure)

    def measure_train(self, bucket: int, b: int) -> dict:
        from vlsat_tpu_torch.train.state import create_train_state
        from vlsat_tpu_torch.train.step import make_train_step

        row = {"bucket": bucket, "batch": b, "mode": "train", "edges": bucket * (bucket - 1)}

        def measure():
            batch = scene_batch(3, bucket, b, with_text=True).to(self.dev)
            state = create_train_state(self.train_model, self.opt, seed=0)
            step = make_train_step(self.train_model, self.opt, device=self.dev)
            calls = [0]

            def one():
                calls[0] += 1
                step(state, batch, calls[0])

            self._cell(row, "train", one, b)

        return self._guard(row, "train", measure)


def lint(rows: list) -> list:
    """(row, mode, key, family median) of every cell whose MFU is more than
    2x out of its family: the other cells of its mode and bucket."""
    flagged = []
    for mode, key in (("eval", "eval_mfu"), ("train", "train_mfu")):
        cells = [r for r in rows if r.get(key) is not None]
        for r in cells:
            family = [c[key] for c in cells if c["bucket"] == r["bucket"] and c is not r]
            if not family:
                continue
            med = float(np.median(family))
            if med > 0 and (r[key] > 2 * med or r[key] < med / 2):
                flagged.append((r, mode, key, med))
    return flagged


def remeasure_outliers(rows: list, measure_eval, measure_train) -> list:
    """Measure each flagged cell once more in place and annotate it; returns
    the fresh rows."""
    fresh_rows = []
    for r, mode, key, med in lint(rows):
        fresh = (measure_eval if mode == "eval" else measure_train)(r["bucket"], r["batch"])
        if fresh.get(key) is not None and (fresh[key] > 2 * med or fresh[key] < med / 2):
            fresh[f"{mode}_outlier"] = (
                f"mfu {fresh[key]} is >2x out of family (bucket-{r['bucket']} median "
                f"{round(med, 4)}); persists after re-measure (first pass: {r[key]})")
        else:
            fresh[f"{mode}_remeasured"] = (
                f"first pass {r[key]} was >2x out of family (median {round(med, 4)}); "
                "re-measure agrees with family")
        rows[rows.index(r)] = fresh
        fresh_rows.append(fresh)
    return fresh_rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--buckets", type=int, nargs="+", default=[8, 12, 16, 24, 32, 48, 64])
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=[4, 8, 16, 32, 64])
    ap.add_argument("--train-batch-sizes", type=int, nargs="+", default=None,
                    help="default: same as --batch-sizes")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (the card by default; cpu for smoke tests)")
    args = ap.parse_args(argv)

    from vlsat_tpu_torch.device import resolve_device

    cells = Cells(resolve_device(args.device), reps=args.reps)
    rows = []
    for bucket in args.buckets:
        for b in sorted(set(args.batch_sizes)):
            rows.append(cells.measure_eval(bucket, b))
            print(json.dumps(rows[-1]), flush=True)
        for b in sorted(set(args.train_batch_sizes or args.batch_sizes)):
            rows.append(cells.measure_train(bucket, b))
            print(json.dumps(rows[-1]), flush=True)
    for fresh in remeasure_outliers(rows, cells.measure_eval, cells.measure_train):
        print("LINT " + json.dumps(fresh), flush=True)
    res = {"peak_flops_per_sec": cells.peak, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
