"""Open-loop serving of SGPN (the 3DSSG baseline: a PointNet over each
instance and one over each edge's union point cloud), through the
program's ``serving.BatchedServer``: ``serve_open_loop``'s traffic, window
and metrics over a model that the benchmark's oracle does not hold.

The program is the registry's ``SGPN`` loaded through
``interop.torch_import.import_sgpn`` from the plain reference's seeded
weights in the original checkpoint layout (``reference/sgpn.py``,
``harness.weights.build_reference``).  Each request carries its scene's
points and descriptor and, for every edge of its full directed graph, the
edge's union cloud (``harness/union.py``: ``num_points_union`` points x 4
channels, float16-exact).  Parameters: ``serve_open_loop``'s.  The
warm-up sends each bucket's largest batch (its largest scene and the
largest others that fit), so the server's packed union blocks reach their
size before the window.  A traced run profiles every
thread (``harness.union.UnionProfile``), so that the kernels launched
inside the program's ``model.union`` span on the server's worker are
attributed to the relation encoder; each traced batch's note is (valid
edges, valid instances).

Correct: every request due in the window answered, and the sampled answers
(``serve_open_loop.sampled``) within the cell's limits of the reference's
forward on the same weights, points and union clouds, in fp32 with TF32
off, in blocks of ``ref_block`` scenes: ``obj_logit_*`` on the object
log-probabilities, ``rel_prob_*`` on the predicate probabilities
(``core.output_gaps``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core, program, roofline, union
from benchmark.harness.weights import build_reference
from benchmark.reference import plain
from benchmark.reference import sgpn as ref_sgpn
from benchmark.traffic import serve_open_loop as base

sampled = base.sampled


def reference(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The plain reference of the configuration on ``device``, its weights
    drawn from ``seed``."""
    return build_reference(ref_sgpn.SGPNReference, device, seed, **cfg["reference"]["kwargs"])


def build(cfg: dict, seed: int, device, mark=lambda what: None) -> torch.nn.Module:
    """The registry's model of ``cfg`` on ``device``, loaded through
    ``import_sgpn`` from the reference's weights drawn from ``seed`` in the
    original checkpoint layout."""
    from vlsat_tpu_torch.config.config import load_config
    from vlsat_tpu_torch.interop import torch_import
    from vlsat_tpu_torch.models.registry import build_model

    mark("program imported")
    layout = ref_sgpn.module_state_dicts(reference(cfg, seed, device))
    mark("weights drawn, copied to the host in the checkpoint layout")
    mcfg = load_config(overrides={"MODEL": cfg["MODEL"]}).MODEL
    model, _ = build_model(cfg["NAME"], cfg["num_obj_classes"], cfg["num_rel_classes"], mcfg)
    model.load_state_dict(torch_import.to_state_dict(torch_import.import_sgpn(layout), model))
    mark("program's model built and loaded")
    return model.to(device).eval()


def make_pool(ctx: core.Context) -> list:
    """``serve_open_loop``'s scenes, each with its union clouds
    (``rel_points``), made from the seed."""
    cfg = ctx.config
    pool = base.make_pool(ctx)
    for scene, clouds in zip(pool, union.make_unions(pool, ctx.seed, cfg["num_points_union"],
                                                     cfg["union_pad"], ctx.device)):
        scene["rel_points"] = clouds
    return pool


class Session(base.Session):
    """``serve_open_loop.Session`` (``offer``, the knee sweep's entry) over
    the SGPN program."""

    def __init__(self, ctx: core.Context):
        from vlsat_tpu_torch.serving import BatchedServer
        from vlsat_tpu_torch.train.step import make_eval_step

        p, cfg, dev = ctx.params, ctx.config, ctx.device
        self.ctx = ctx
        self.model = build(cfg, ctx.seed, dev, ctx.mark)
        self.pool = make_pool(ctx)
        self.requests = [{k: s[k] for k in ("obj_points", "descriptor", "rel_points")}
                         for s in self.pool]
        self.sizes = np.array([len(s["gt_class"]) for s in self.pool])
        ctx.mark(f"{len(self.pool)} scenes and their union clouds made")
        self.spans = program.StepSpans()
        inner = make_eval_step(self.model, branch_3d_only=p["branch_3d_only"], device=dev)
        weights = self.model.state_dict()

        def served(_state, batch):  # the weights stay bound, as the server's own step binds them
            return inner(weights, batch)

        served.device = inner.device
        step = self.spans.wrap(served, note=lambda _state, batch: (
            int(batch.edge_mask.sum()), int(batch.obj_mask.sum())))
        step.union_rows = inner.union_rows
        self.server = BatchedServer(eval_step=step, max_batch=p["max_batch"],
                                    deadline_ms=p["deadline_ms"], pad_to_max=p["pad_to_max"],
                                    feat_dim=cfg["MODEL"]["clip_feat_dim"],
                                    num_rel_classes=cfg["num_rel_classes"]).start()
        # warm-up: in each bucket the largest batch the pool can make (its largest
        # scene and the next largest that fit), so each union block has its size
        by_size = np.argsort(-self.sizes, kind="stable")
        for _ in range(3):
            for idx in program.bucket_rows(self.sizes).values():
                fit = [i for i in by_size if self.sizes[i] <= max(self.sizes[idx])]
                for f in [self.server.submit(self.requests[i]) for i in fit[:p["max_batch"]]]:
                    f.result(timeout=600)
        program.synchronize(dev)
        program.settle()
        ctx.mark("server warm")


def run(ctx: core.Context) -> dict:
    p, cfg, dev = ctx.params, ctx.config, ctx.device
    sess = Session(ctx)
    prof = union.UnionProfile(dev) if ctx.trace else None
    if prof is not None:
        prof.warm()
        ctx.mark("profiler warm")
    t_start = time.perf_counter()
    w = sess.offer(p["rate"], ctx.seconds, ctx.seed, prof, p["trace_s"])
    sess.server.stop()
    answered, done = w["answered"], w["done"]
    obs = {"kind": "serve", "setup_s": t_start - ctx.t_process, "window_s": ctx.seconds,
           "attempted": len(answered), "failed": int((~answered).sum()),
           "memory_peak_bytes": program.memory_peak(dev), "power_limit": program.power_limit(dev),
           "peaks": roofline.peaks(torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else None),
           "pointnet_flops": (union.pointnet_flops(cfg["num_points_union"], 4,
                                                   ref_sgpn.REL_WIDTHS),
                              union.pointnet_flops(cfg["num_points"], 3, ref_sgpn.OBJ_WIDTHS)),
           "checks": []}
    obs.update({k: w[k] for k in ("latencies_ms", "answered_in_window", "late_ms_p99",
                                  "batches", "fill")})
    ctx.log(f"{ctx.cell['name']}: {len(answered)} requests offered at {p['rate']} /s, "
            f"{obs['answered_in_window']} answered in the window, {obs['failed']} failed, "
            f"{obs['batches']} batches, generator late p99 {obs['late_ms_p99']:.3f} ms")
    pool, sizes, which = sess.pool, sess.sizes, w["which"]
    if prof is not None and prof.summary is not None:
        n0, n1 = w["spans"]
        obs["trace"] = prof.summary
        obs["traced_batches"] = [sess.spans.notes[k] for k in range(n0, n1)
                                 if prof.contains(sess.spans.starts[k])]
        in_slice = answered & (done >= prof.t0) & (done <= prof.t1)
        obs["traced_flops"] = float(sum(union.sgpn_flops(sizes[i], len(pool[i]["edge_index"]),
                                                         cfg) for i in which[in_slice]))
    results = [f.result() if a else None for f, a in zip(w["futs"], answered)]
    del sess, w
    program.free(dev)

    with torch.no_grad():
        plain.set_tf32(False)
        if answered.any():
            compare(ctx, reference(cfg, ctx.seed, dev), pool, which, results, answered, sizes,
                    obs)
    return obs


def forward(ref, scenes: list, device, rows: int = 2048) -> list:
    """The reference's answers for ``scenes`` (one block): per scene its
    object log-probabilities and predicate probabilities, on the host."""
    blk = plain.flatten(scenes, device)
    clouds = torch.from_numpy(np.concatenate([s["rel_points"] for s in scenes]))
    res = ref.forward_3d(blk, clouds, rows=rows)
    return [{"obj": res["obj_logits_3d"][a:b].cpu(), "rel": res["rel_cls_3d"][c:d].cpu()}
            for (a, b), (c, d) in zip(blk["nodes"], blk["edges"])]


def compare(ctx, ref, pool, which, results, answered, sizes, obs) -> None:
    """The sampled answers (``results[i]``: the ``obj_logits`` and
    ``rel_cls`` arrays of request ``i``, for scene ``pool[which[i]]``)
    against the reference, in blocks of scenes."""
    p = ctx.params
    pick = sampled(ctx, which, answered, sizes)
    got, want = [], []
    for lo in range(0, len(pick), p["ref_block"]):
        block = pick[lo:lo + p["ref_block"]]
        want += forward(ref, [pool[which[i]] for i in block], ctx.device)
        got += [{"obj": torch.from_numpy(results[i]["obj_logits"]),
                 "rel": torch.from_numpy(results[i]["rel_cls"])} for i in block]
    for name, value in core.output_gaps(got, want).items():
        if name in ctx.limits:  # a number without a limit does not separate its readings
            core.check(obs["checks"], name, value, ctx.limits[name])
    obs["compared"] = len(pick)
