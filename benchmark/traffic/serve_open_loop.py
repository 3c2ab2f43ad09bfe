"""Open-loop serving traffic through the program's ``serving.BatchedServer``.

Independent clients send scenes on a fixed schedule whether or not earlier
ones were answered, so a stall delays every later request and the queue can
grow.  Each request is timed from when it was due to when its future
resolved.  The schedule: ``rate`` scenes/s for the window, Poisson-like,
from a fixed set of gaps (the exponential distribution's quantiles at
(k + 0.5) / M) in an order drawn from the seed, so every seed offers the
same arrivals in another order.  Requests cycle through a pool of
scenes (``harness.scenes``), reshuffled each cycle; a request carries the
points and the descriptor of its scene, as a client of the HTTP frontend
sends them, and the server builds its full graph.

Parameters (the cell's ``params``): ``scenes`` and ``max_nodes`` (the pool),
``rate``, ``max_batch``, ``deadline_ms``, ``pad_to_max``,
``branch_3d_only`` (the server's; its buckets are the program's
``scene.DEFAULT_NODE_BUCKETS``), ``grace_s`` (how long
after the window an answer may still come), ``trace_s`` (the profiled slice
at the end of the window in a traced run), ``sample`` (answers compared with
the reference) and ``ref_block`` (scenes a reference call).

Correct: every request due in the window answered, and the sampled answers
(the seed's draw, with the largest scene answered) within the cell's limits
of the reference's 3D branch on the same weights and points.  The reference
is built from the seed once the window has closed and the program's state
is freed.
"""

from __future__ import annotations

import concurrent.futures
import math
import time

import numpy as np
import torch

from benchmark.harness import core, program, roofline, scenes
from benchmark.harness.trace import Profile
from benchmark.reference import plain


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of the requests offered."""
    m = int(round(rate * seconds))
    gaps = -np.log1p(-(np.arange(m) + 0.5) / m) * seconds / m
    gaps = gaps[scenes.order(m, seed, salt=1)]
    due = np.cumsum(gaps) - gaps[0]
    return due[due < seconds]


def make_pool(ctx: core.Context) -> list:
    """The cell's scenes, made from the seed (``harness.scenes``)."""
    p, cfg = ctx.params, ctx.config
    return scenes.make_scenes(
        scenes.label_specs(p["scenes"], p.get("max_nodes")), ctx.seed,
        num_points=cfg["num_points"], with_2d=False, feat_dim=cfg["MODEL"]["clip_feat_dim"],
        num_rel=cfg["num_rel_classes"])


class Session:
    """The program's server over the configuration's model, its pool of
    requests and the benchmark's span of each batch, warmed up."""

    def __init__(self, ctx: core.Context):
        from vlsat_tpu_torch.serving import BatchedServer
        from vlsat_tpu_torch.train.step import make_eval_step

        p, cfg, dev = ctx.params, ctx.config, ctx.device
        self.ctx = ctx
        self.model, _, _ = program.build(cfg, ctx.seed, dev, ctx.mark)
        self.pool = make_pool(ctx)
        self.requests = [{"obj_points": s["obj_points"], "descriptor": s["descriptor"]}
                         for s in self.pool]
        self.sizes = np.array([len(s["gt_class"]) for s in self.pool])
        ctx.mark(f"{len(self.pool)} scenes made")
        self.spans = program.StepSpans()
        inner = make_eval_step(self.model, branch_3d_only=p["branch_3d_only"], device=dev)
        weights = self.model.state_dict()

        def served(_state, batch):  # the weights stay bound, as the server's own step binds them
            return inner(weights, batch)

        served.device = inner.device
        step = self.spans.wrap(served, note=lambda _state, batch: (
            int(batch.edge_mask.sum()), batch.num_scenes, batch.num_nodes, batch.num_edges))
        self.server = BatchedServer(eval_step=step, max_batch=p["max_batch"],
                                    deadline_ms=p["deadline_ms"], pad_to_max=p["pad_to_max"],
                                    feat_dim=cfg["MODEL"]["clip_feat_dim"],
                                    num_rel_classes=cfg["num_rel_classes"]).start()
        # warm-up: every batch shape this pool's buckets use, a few times over
        for _ in range(3):
            for idx in program.bucket_rows(self.sizes).values():
                for f in [self.server.submit(self.requests[i]) for i in idx[:p["max_batch"]]]:
                    f.result(timeout=600)
        program.synchronize(dev)
        program.settle()
        ctx.mark("server warm")

    def offer(self, rate: float, seconds: float, seed: int, prof: Profile = None,
              trace_s: float = 0.0) -> dict:
        """One open-loop window at ``rate``; with ``prof``, the last
        ``trace_s`` seconds of it profiled."""
        p = self.ctx.params
        due = arrivals(rate, seconds, seed)
        m = len(due)
        which = np.concatenate([scenes.order(len(self.pool), seed, salt=10 + c)
                                for c in range(math.ceil(m / len(self.pool)))])[:m]
        done, sent, futs = np.full(m, np.nan), np.zeros(m), []
        trace_from = seconds - min(trace_s, seconds / 2)
        stats0, n0 = dict(self.server.stats), len(self.spans.starts)

        def stamp(i):
            return lambda _f: done.__setitem__(i, time.perf_counter())

        t0 = time.perf_counter()
        for i in range(m):
            if prof is not None and prof.t0 is None and due[i] >= trace_from:
                prof.start()
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent[i] = time.perf_counter()
            fut = self.server.submit(self.requests[which[i]])
            fut.add_done_callback(stamp(i))
            futs.append(fut)
        t_end = t0 + seconds
        rest = t_end - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        if prof is not None and prof.active:
            prof.stop()
        stats1, n1 = dict(self.server.stats), len(self.spans.starts)
        backlog = int(np.sum(~(done <= t_end)))
        concurrent.futures.wait(futs, timeout=max(t_end + p["grace_s"] - time.perf_counter(), 0))
        answered = np.array([f.done() and f.exception() is None for f in futs], bool)
        batches = stats1["batches"] - stats0["batches"]
        return {"t0": t0, "t_end": t_end, "due": due, "done": done, "which": which,
                "futs": futs, "answered": answered, "backlog": backlog,
                "latencies_ms": np.where(answered, done - (t0 + due),
                                         t_end + p["grace_s"] - (t0 + due)) * 1e3,
                "answered_in_window": int(np.sum(answered & (done <= t_end))),
                "late_ms_p99": float(np.percentile((sent - t0 - due) * 1e3, 99)) if m else 0.0,
                "batches": batches, "spans": (n0, n1),
                "fill": ((stats1["batch_size_sum"] - stats0["batch_size_sum"])
                         / max(batches, 1) / p["max_batch"])}


def run(ctx: core.Context) -> dict:
    p, cfg, dev = ctx.params, ctx.config, ctx.device
    sess = Session(ctx)
    prof = Profile(dev) if ctx.trace else None
    t_start = time.perf_counter()
    w = sess.offer(p["rate"], ctx.seconds, ctx.seed, prof, p["trace_s"])
    sess.server.stop()
    answered, done = w["answered"], w["done"]
    obs = {"kind": "serve", "setup_s": t_start - ctx.t_process, "window_s": ctx.seconds,
           "attempted": len(answered), "failed": int((~answered).sum()),
           "memory_peak_bytes": program.memory_peak(dev), "power_limit": program.power_limit(dev),
           "segment_max_dim": cfg["MODEL"]["DIM_ATTEN"],
           "peaks": roofline.peaks(torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else None),
           "checks": []}
    obs.update({k: w[k] for k in ("latencies_ms", "answered_in_window", "late_ms_p99",
                                  "batches", "fill")})
    ctx.log(f"{ctx.cell['name']}: {len(answered)} requests offered at {p['rate']} /s, "
            f"{obs['answered_in_window']} answered in the window, {obs['failed']} failed, "
            f"{obs['batches']} batches, generator late p99 {obs['late_ms_p99']:.3f} ms")
    if prof is not None and prof.summary is not None:
        n0, n1 = w["spans"]
        obs["trace"] = prof.summary
        obs["traced_batches"] = [sess.spans.notes[k] for k in range(n0, n1)
                                 if prof.contains(sess.spans.starts[k])]
        in_slice = answered & (done >= prof.t0) & (done <= prof.t1)
        obs["traced_scene_sizes"] = sess.sizes[w["which"][in_slice]]
    results = [f.result() if a else None for f, a in zip(w["futs"], answered)]
    pool, sizes, which = sess.pool, sess.sizes, w["which"]
    del sess, w
    program.free(dev)

    with torch.no_grad():
        plain.set_tf32(False)
        ref = program.reference(cfg, ctx.seed, dev)
        if answered.any():
            compare(ctx, ref, pool, which, results, answered, sizes, obs)
        if "traced_scene_sizes" in obs:
            obs["traced_flops"] = traced_flops(ref, pool, sizes, obs["traced_scene_sizes"], dev)
    return obs


def sampled(ctx, which, answered, sizes) -> np.ndarray:
    """The requests whose answers are compared: the seed's draw of
    ``sample`` answered ones, with the one of the largest scene."""
    idx = np.flatnonzero(answered)
    largest = int(idx[np.argmax(sizes[which[idx]])])
    return core.sample(idx, ctx.params["sample"], ctx.seed, salt=2, must=largest)


def compare(ctx, ref, pool, which, results, answered, sizes, obs) -> None:
    """The sampled answers (``results[i]``: the ``obj_logits`` and
    ``rel_cls`` arrays of request ``i``, for scene ``pool[which[i]]``)
    against the reference's 3D branch, in blocks of scenes."""
    p = ctx.params
    pick = sampled(ctx, which, answered, sizes)
    got, want = [], []
    for lo in range(0, len(pick), p["ref_block"]):
        block = pick[lo:lo + p["ref_block"]]
        blk = plain.flatten([pool[which[i]] for i in block], ctx.device)
        res = plain.mmgnet_3d(ref, blk)
        for j, i in enumerate(block):
            (a, b), (c, d) = blk["nodes"][j], blk["edges"][j]
            got.append({"obj": torch.from_numpy(results[i]["obj_logits"]),
                        "rel": torch.from_numpy(results[i]["rel_cls"])})
            want.append({"obj": res["obj_logits_3d"][a:b].cpu(),
                         "rel": res["rel_cls_3d"][c:d].cpu()})
    for name, value in core.output_gaps(got, want).items():
        if name in ctx.limits:  # a number without a limit does not separate its readings
            core.check(obs["checks"], name, value, ctx.limits[name])
    obs["compared"] = len(pick)


def traced_flops(ref, pool, sizes, traced_sizes, dev) -> float:
    """FLOPs of the reference's 3D branch over the scenes answered in the
    profiled slice, each at its own node count."""
    per_n = {}
    for n in np.unique(traced_sizes):
        scene = pool[int(np.flatnonzero(sizes == n)[0])]
        blk = plain.flatten([scene], dev)
        per_n[int(n)] = roofline.count_flops(lambda: plain.mmgnet_3d(ref, blk))
    return float(sum(per_n[int(n)] for n in traced_sizes))
