"""Whole evaluation passes through the program's ``eval.engine.evaluate``,
as ``main --eval`` and per-epoch validation run it.

The split is the pool of ``harness.scenes`` (``scenes``), in an order drawn
from the seed, packed in the program's layout and placed on the card by its
resident loader (``data.resident.ResidentScenes``); ``evaluate`` takes the
grouped loader (``ResidentGroupedEval``: ``group`` batches a copy out, batch
``batch``, "auto" = the program's per-bucket table) and the eval step of
``train.step.make_eval_step`` (the dual forward unless ``branch_3d_only``),
with ``evaluate``'s defaults (no scene recall).  ``max_scenes`` cuts the
split (the CPU tests; the cells leave it out).
Set-up runs ``warm_passes`` passes; the window repeats whole passes until
``--seconds`` have passed.  A traced run profiles the passes that start in
the last ``trace_s`` seconds.

Correct (``compare``): every pass's metric dict equal to the first's; the
first window pass's metric dict equal to the plain metrics over the step
outputs that pass consumed; the step outputs of a sample of scenes (the
seed's draw of ``sample``, with the largest) within the limits of the
reference's dual forward on the same weights and inputs.  The reference is
built from the seed once the window has closed and the program's state is
freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core, program, roofline, scenes
from benchmark.harness.trace import Profile
from benchmark.reference import metrics as ref_metrics
from benchmark.reference import plain

KEYS = ("obj_logits_3d", "rel_cls_3d", "obj_logits_2d", "rel_cls_2d")


def schedule(pack, batch, group: int) -> list:
    """(bucket, rows) of each eval-step call of one pass, in the order the
    grouped resident loader makes them: buckets ascending, ``group``
    batches a group, tail rows clamped to the last scene, a tail group
    repeating its last batch."""
    from vlsat_tpu_torch.data.bucket_batch import resolve_batch

    calls = []
    for b in pack.buckets:
        c, bs = pack.count(b), resolve_batch(batch, b)
        starts = list(range(0, c, bs))
        for g0 in range(0, len(starts), group):
            chunk = starts[g0:g0 + group]
            chunk = chunk + [chunk[-1]] * (group - len(chunk))
            calls += [(b, np.minimum(np.arange(s, s + bs), c - 1)) for s in chunk]
    return calls


def make_pool(ctx: core.Context) -> list:
    """The cell's split, made from the seed (``harness.scenes``) in an
    order drawn from it."""
    p, cfg = ctx.params, ctx.config
    specs = scenes.label_specs(p["scenes"], p.get("max_nodes"))
    specs = [specs[i] for i in scenes.order(len(specs), ctx.seed, salt=3)][:p.get("max_scenes")]
    return scenes.make_scenes(specs, ctx.seed, num_points=cfg["num_points"],
                              feat_dim=cfg["MODEL"]["clip_feat_dim"],
                              num_rel=cfg["num_rel_classes"])


def run(ctx: core.Context) -> dict:
    from vlsat_tpu_torch.data.bucket_batch import DEFAULT_EVAL_BATCH
    from vlsat_tpu_torch.data.resident import ResidentGroupedEval, ResidentScenes
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.scene import edge_count
    from vlsat_tpu_torch.train.step import make_eval_step

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    model, _, _ = program.build(cfg, ctx.seed, dev, ctx.mark)
    pool = make_pool(ctx)
    sizes = np.array([len(s["gt_class"]) for s in pool])
    pack = program.memory_pack(pool, feat_dim=cfg["MODEL"]["clip_feat_dim"])
    batch = dict(DEFAULT_EVAL_BATCH) if p["batch"] == "auto" else p["batch"]
    loader = ResidentGroupedEval(ResidentScenes(pack, device=dev), batch, group=p["group"])
    calls = schedule(pack, batch, p["group"])
    ctx.mark(f"{len(pool)} scenes made, packed and resident")
    weights = model.state_dict()

    spans = program.StepSpans()
    inner = spans.wrap(make_eval_step(model, branch_3d_only=p["branch_3d_only"], device=dev))
    captured = []

    def step(state, b):
        out = inner(state, b)
        if capture[0]:
            captured.append({k: out[k].clone() for k in KEYS if out.get(k) is not None})
        return out

    step.device = inner.device
    capture = [False]

    def one_pass():
        return evaluate(step, weights, loader, num_rel_classes=cfg["num_rel_classes"],
                        verbose=False, multi_rel=cfg["MODEL"]["multi_rel_outputs"])

    for _ in range(p["warm_passes"]):
        one_pass()
    program.synchronize(dev)
    program.settle()
    ctx.mark("warm passes done")

    prof = Profile(dev)
    bounds, results = [], []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    while True:
        start = time.perf_counter()
        if start - t0 >= ctx.seconds:
            break
        if ctx.trace and prof.t0 is None and start - t0 >= ctx.seconds - p["trace_s"]:
            prof.start()
        capture[0] = not results
        n0 = len(spans.starts)
        results.append(one_pass())
        bounds.append((start, time.perf_counter(), n0, len(spans.starts)))
    t_end = time.perf_counter()
    capture[0] = False
    if prof.active:
        prof.stop()
    passes = len(results)
    obs = {"kind": "eval", "setup_s": setup_s, "window_s": t_end - t0, "passes": passes,
           "scenes": passes * len(pool), "attempted": passes * len(pool), "failed": 0,
           "memory_peak_bytes": program.memory_peak(dev), "power_limit": program.power_limit(dev),
           "segment_max_dim": cfg["MODEL"]["DIM_ATTEN"],
           "peaks": roofline.peaks(torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else None),
           "checks": []}
    untraced = [b for b in bounds if not prof.contains(b[0])]
    traced = [b for b in bounds if prof.contains(b[0])]
    if untraced:
        obs["host_spans"] = (
            sum(b[1] - b[0] for b in untraced),
            sum(spans.ends[k] - spans.starts[k] for b in untraced for k in range(b[2], b[3])),
            sum(b[3] - b[2] for b in untraced))
    notes = [(sum(edge_count(int(sizes[pack.rows[b][r]])) for r in rows), len(rows), b,
              edge_count(b)) for b, rows in calls]
    if prof.summary is not None and traced:
        obs["trace"] = prof.summary
        obs["traced_batches"] = notes * len(traced)
    ctx.log(f"{ctx.cell['name']}: {passes} passes of {len(pool)} scenes in "
            f"{obs['window_s']:.3f} s, {len(calls)} step calls a pass")
    where = {}  # scene -> (call, position in the batch), first occurrence
    for j, (b, rows) in enumerate(calls):
        for k, r in enumerate(rows):
            where.setdefault(pack.rows[b][r], (j, k))
    del loader, step, inner, weights, model
    program.free(dev)

    with torch.no_grad():
        plain.set_tf32(False)
        ref = program.reference(cfg, ctx.seed, dev)
        compare(ctx, ref, pool, lambda i: outputs_of(captured, where, i, pool[i]), results, obs)
        if "trace" in obs:
            per_n = {}
            for n in np.unique(sizes):
                blk = plain.flatten([pool[int(np.flatnonzero(sizes == n)[0])]], dev)
                per_n[int(n)] = roofline.count_flops(lambda: plain.mmgnet_dual(ref, blk))
            obs["traced_flops"] = len(traced) * float(sum(per_n[int(n)] for n in sizes))
    return obs


def outputs_of(captured, where, i: int, scene: dict) -> dict:
    """Scene ``i``'s unpadded step outputs among the captured calls."""
    call, k = where[i]
    n, e = len(scene["gt_class"]), len(scene["edge_index"])
    return {key: captured[call][key][k, :n if key.startswith("obj") else e] for key in KEYS}


def plain_metrics(ctx, pool, outputs) -> dict:
    """The plain metric dict (``reference/metrics.py``) over scene ``i``'s
    outputs ``outputs(i)``, scene by scene, in blocks of ``ref_block``."""
    parts = []
    for lo in range(0, len(pool), ctx.params["ref_block"]):
        ids = list(range(lo, min(lo + ctx.params["ref_block"], len(pool))))
        blk = plain.flatten([pool[i] for i in ids], ctx.device)
        outs = [outputs(i) for i in ids]
        served = {k: torch.cat([o[k] for o in outs]) for k in KEYS}
        parts.append({tag: ref_metrics.scene_ranks(
            served[f"obj_logits_{tag}"], served[f"rel_cls_{tag}"], blk["gt_class"],
            blk["gt_rels"], blk["edge_index"]) for tag in ("3d", "2d")})
    return ref_metrics.metrics(parts, num_rel=ctx.config["num_rel_classes"])


def compare(ctx, ref, pool, outputs, results, obs) -> None:
    """Three comparisons.  Every pass's metric dict (``results``) equals the
    first's.  The metric dict of the window's first pass equals the plain
    metrics over the step outputs that pass consumed (``outputs(i)``: scene
    ``i``'s, unpadded), scene by scene (the engine, the rank functions and
    the assembly, judged on the program's own outputs).  The step outputs of
    a sample of scenes lie within the limits of the reference's dual forward
    on the same weights and inputs (the model and the kernel)."""
    p = ctx.params
    checks = obs["checks"]
    keys = sorted(results[0])
    core.check(checks, "passes_differ",
               sum(any(r[k] != results[0][k] for k in keys) for r in results[1:]), 0)
    sizes = np.array([len(s["gt_class"]) for s in pool])
    pick = core.sample(np.arange(len(pool)), p["sample"], ctx.seed, salt=4,
                       must=int(np.argmax(sizes)))
    got_out, want_out = [], []
    for i in pick:
        # one scene a call, as the original reference evaluates: its 2D edge
        # cross-attention has no scene mask
        want = plain.mmgnet_dual(ref, plain.flatten([pool[i]], ctx.device))
        got = outputs(int(i))
        for tag in ("3d", "2d"):
            got_out.append({"obj": got[f"obj_logits_{tag}"], "rel": got[f"rel_cls_{tag}"]})
            want_out.append({"obj": want[f"obj_logits_{tag}"], "rel": want[f"rel_cls_{tag}"]})
    want_metrics = plain_metrics(ctx, pool, outputs)
    gap = max(abs(results[0][k] - v) for k, v in want_metrics.items())
    for name, value in core.output_gaps(got_out, want_out).items():
        if name in ctx.limits:  # a number without a limit does not separate its readings
            core.check(checks, name, value, ctx.limits[name])
    core.check(checks, "metric_gap", gap, ctx.limits["metric_gap"])
    obs["compared"] = len(pick)
