"""Open-loop serving of SGGpoint (VL-SAT's DGCNN + EdgeGCN model), 3D only,
through the program's ``serving.BatchedServer``: ``serve_open_loop``'s
traffic, window and metrics over a model that the benchmark's oracle does
not hold.

The program is the registry's ``SGGpoint`` loaded through
``interop.torch_import.import_sggpoint`` from the plain reference's seeded
weights in the original checkpoint layout (``reference/sggpoint.py``,
``harness.weights.build_reference``).  Parameters: ``serve_open_loop``'s.
A traced run profiles every thread (``harness.dgcnn.AllThreadsProfile``),
so that the kernels launched inside the program's ``model.dgcnn`` span on
the server's worker are attributed to the DGCNN.

Correct: every request due in the window answered, and then, for the
sampled answers (``serve_open_loop.sampled``):

* ``replay_gap``: each sampled scene replayed alone through a server of
  the same settings (so the same padded (max_batch, bucket) batch shape),
  its answers against the timed ones; the replay records the program's kNN
  sets and their stage inputs (``vlsat_tpu_torch.ops.dgcnn.knn_indices``
  wrapped for the replay only);
* ``knn_set_excess``: for every recorded (instance, point, stage) set, its
  farthest member's float64 squared distance less the float64 k-th
  (``reference/sggpoint.py`` ``knn64``, on the program's own stage input),
  over the fp32 rounding bound of the distance expression for those two
  points, gamma_(C+2) ((|x_i| + |x_j|)^2 + (|x_i| + |x_t|)^2) with
  gamma_n = n u / (1 - n u), u = 2^-24: the largest share of its bound
  (at most 1 for every set that is a true kNN up to fp32 rounding);
* ``knn_sets_off``: the share of sets whose farthest member lies beyond
  the float64 k-th distance (exact ties count as equal);
* ``obj_logit_*`` / ``rel_prob_*`` (``core.output_gaps``): the timed
  answers against the reference's 3D forward on the same weights, given
  the recorded sets, in fp32 with TF32 off, in blocks of ``ref_block``
  scenes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core, program, roofline
from benchmark.harness.dgcnn import AllThreadsProfile, dgcnn_factored_flops
from benchmark.harness.weights import build_reference
from benchmark.reference import plain
from benchmark.reference import sggpoint as ref_sggpoint
from benchmark.traffic import serve_open_loop as base

make_pool = base.make_pool
sampled = base.sampled
U32 = 2.0 ** -24


def reference(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The plain reference of the configuration on ``device``, its weights
    drawn from ``seed``."""
    return build_reference(ref_sggpoint.SGGpointReference, device, seed,
                           **cfg["reference"]["kwargs"])


def build(cfg: dict, seed: int, device, mark=lambda what: None) -> torch.nn.Module:
    """The registry's model of ``cfg`` on ``device``, loaded through
    ``import_sggpoint`` from the reference's weights drawn from ``seed`` in
    the original checkpoint layout (host arrays by child module)."""
    from vlsat_tpu_torch.config.config import load_config
    from vlsat_tpu_torch.interop import torch_import
    from vlsat_tpu_torch.models.registry import build_model

    mark("program imported")
    drawn = reference(cfg, seed, device)
    program.synchronize(device)
    layout = ref_sggpoint.module_state_dicts(drawn)
    del drawn
    mark("weights drawn, copied to the host in the checkpoint layout")
    mcfg = load_config(overrides={"MODEL": cfg["MODEL"]}).MODEL
    model, _ = build_model(cfg["NAME"], cfg["num_obj_classes"], cfg["num_rel_classes"], mcfg)
    model.load_state_dict(torch_import.to_state_dict(torch_import.import_sggpoint(layout),
                                                     model))
    mark("program's model built and loaded")
    return model.to(device).eval()


class Session(base.Session):
    """``serve_open_loop.Session`` (``offer``, the knee sweep's entry) over
    the SGGpoint program; each step's note is (valid instances, instance
    slots)."""

    def __init__(self, ctx: core.Context):
        from vlsat_tpu_torch.train.step import make_eval_step

        p, cfg, dev = ctx.params, ctx.config, ctx.device
        self.ctx = ctx
        self.model = build(cfg, ctx.seed, dev, ctx.mark)
        self.pool = make_pool(ctx)
        self.requests = [{"obj_points": s["obj_points"], "descriptor": s["descriptor"]}
                         for s in self.pool]
        self.sizes = np.array([len(s["gt_class"]) for s in self.pool])
        ctx.mark(f"{len(self.pool)} scenes made")
        self.spans = program.StepSpans()
        step = self.spans.wrap(self.served(make_eval_step(
            self.model, branch_3d_only=p["branch_3d_only"], device=dev)),
            note=lambda _state, batch: (int(batch.obj_mask.sum()), batch.obj_mask.numel()))
        self.server = self.new_server(step)
        for _ in range(3):  # warm-up: every batch shape of the pool's buckets
            for idx in program.bucket_rows(self.sizes).values():
                for f in [self.server.submit(self.requests[i]) for i in idx[:p["max_batch"]]]:
                    f.result(timeout=600)
        program.synchronize(dev)
        program.settle()
        ctx.mark("server warm")

    def served(self, inner):
        weights = self.model.state_dict()

        def step(_state, batch):  # the weights stay bound, as the server's own step binds them
            return inner(weights, batch)

        step.device = inner.device
        return step

    def new_server(self, step):
        from vlsat_tpu_torch.serving import BatchedServer

        p, cfg = self.ctx.params, self.ctx.config
        return BatchedServer(eval_step=step, max_batch=p["max_batch"],
                             deadline_ms=p["deadline_ms"], pad_to_max=p["pad_to_max"],
                             feat_dim=cfg["MODEL"]["clip_feat_dim"],
                             num_rel_classes=cfg["num_rel_classes"]).start()

    def replay(self, scene_ids) -> list:
        """Each scene of ``scene_ids`` alone through a new server of the same
        settings; per scene its answer, and per EdgeConv stage the program's
        stage input (n, P, C) and kNN sets (n, P, k) of its n instances."""
        from vlsat_tpu_torch.ops import dgcnn
        from vlsat_tpu_torch.train.step import make_eval_step

        seen = []
        real = dgcnn.knn_indices

        def recording(x, k):
            idx = real(x, k)
            seen.append((x[0].cpu(), idx[0].cpu()))  # the scene is the batch's first row
            return idx

        server = self.new_server(self.served(make_eval_step(
            self.model, branch_3d_only=self.ctx.params["branch_3d_only"],
            device=self.ctx.device)))
        out = []
        dgcnn.knn_indices = recording
        try:
            for i in scene_ids:
                seen.clear()
                answer = server.submit(self.requests[i]).result(timeout=600)
                n = int(self.sizes[i])
                out.append({"answer": answer, "inputs": [x[:n] for x, _ in seen],
                            "sets": [s[:n] for _, s in seen]})
        finally:
            dgcnn.knn_indices = real
            server.stop()
        return out


def run(ctx: core.Context) -> dict:
    p, cfg, dev = ctx.params, ctx.config, ctx.device
    sess = Session(ctx)
    prof = AllThreadsProfile(dev) if ctx.trace else None
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
           "dgcnn_flops_per_instance": dgcnn_factored_flops(cfg["num_points"])[0],
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
    replays = None
    if answered.any():
        pick = sampled(ctx, which, answered, sizes)
        replays = dict(zip(pick.tolist(), sess.replay([which[i] for i in pick])))
    del sess, w
    program.free(dev)

    with torch.no_grad():
        plain.set_tf32(False)
        ref = reference(cfg, ctx.seed, dev)
        if replays:
            compare(ctx, ref, pool, which, results, replays, obs)
        if "traced_scene_sizes" in obs:
            obs["traced_flops"] = traced_flops(ref, pool, sizes, obs["traced_scene_sizes"], dev,
                                               obs["dgcnn_flops_per_instance"])
    return obs


def knn_checks(inputs: list, sets: list) -> dict:
    """``knn_set_excess`` and ``knn_sets_off`` of the recorded sets
    (``inputs``: stage inputs (n, P, C); ``sets``: (n, P, k)), and the count
    of sets."""
    worst, off, count = -np.inf, 0, 0
    for x, idx in zip(inputs, sets):
        x = x.double()
        k, c = idx.shape[-1], x.shape[-1]
        near = ref_sggpoint.knn64(x.transpose(1, 2), k)
        dist, norm = near["dist"], x.norm(dim=-1)                  # (n, P, P), (n, P)
        member = dist.gather(-1, idx.long())                         # (n, P, k)
        far = member.argmax(-1, keepdim=True)
        excess = member.gather(-1, far)[..., 0] - near["kth"]
        j = idx.long().gather(-1, far)[..., 0]
        t = near["idx"][..., k - 1]
        gamma = (c + 2) * U32 / (1 - (c + 2) * U32)
        bound = gamma * ((norm + norm.gather(-1, j)) ** 2 + (norm + norm.gather(-1, t)) ** 2)
        worst = max(worst, float((excess / bound.clamp(min=1e-300)).max()))
        off += int((excess > 0).sum())
        count += excess.numel()
    return {"knn_set_excess": worst, "knn_sets_off": off / max(count, 1), "sets": count}


def compare(ctx, ref, pool, which, results, replays, obs) -> None:
    """The sampled answers (``results[i]`` of request ``i``, for scene
    ``pool[which[i]]``; ``replays[i]`` its replay) against their replay,
    their kNN sets against the float64 kNN, and the answers against the
    reference's 3D forward given those sets, in blocks of scenes."""
    p = ctx.params
    pick = sorted(replays)
    gap = 0.0
    for i in pick:
        a, b = results[i], replays[i]["answer"]
        for key in ("obj_logits", "rel_cls"):
            gap = max(gap, float(np.abs(a[key].astype(np.float64) - b[key]).max()))
    knn = knn_checks([x for i in pick for x in replays[i]["inputs"]],
                     [s for i in pick for s in replays[i]["sets"]])
    got, want = [], []
    for lo in range(0, len(pick), p["ref_block"]):
        block = pick[lo:lo + p["ref_block"]]
        blk = plain.flatten([pool[which[i]] for i in block], ctx.device)
        stages = len(replays[block[0]]["sets"])
        sets = [torch.cat([replays[i]["sets"][s] for i in block]).to(ctx.device).long()
                for s in range(stages)]
        res = ref.forward_3d(blk, sets)
        for j, i in enumerate(block):
            (a, b), (c, d) = blk["nodes"][j], blk["edges"][j]
            got.append({"obj": torch.from_numpy(results[i]["obj_logits"]),
                        "rel": torch.from_numpy(results[i]["rel_cls"])})
            want.append({"obj": res["obj_logits_3d"][a:b].cpu(),
                         "rel": res["rel_cls_3d"][c:d].cpu()})
    numbers = {"replay_gap": gap, "knn_set_excess": knn["knn_set_excess"],
               "knn_sets_off": knn["knn_sets_off"], **core.output_gaps(got, want)}
    for name, value in numbers.items():
        if name in ctx.limits:  # a number without a limit does not separate its readings
            core.check(obs["checks"], name, value, ctx.limits[name])
    obs["compared"] = len(pick)
    obs["knn_sets"] = knn["sets"]


def traced_flops(ref, pool, sizes, traced_sizes, dev, per_instance: int) -> float:
    """FLOPs of the 3D branch over the scenes answered in the profiled
    slice, each at its own node count: the DGCNN in its factored form
    (``harness.dgcnn``) and the rest counted by ``FlopCounterMode`` on the
    reference."""
    per_n = {}
    for n in np.unique(traced_sizes):
        blk = plain.flatten([pool[int(np.flatnonzero(sizes == n)[0])]], dev)
        pooled = ref.backbone_3d(blk["obj_points"])
        per_n[int(n)] = int(n) * per_instance + roofline.count_flops(
            lambda: ref.head_3d(pooled, blk))
    return float(sum(per_n[int(n)] for n in traced_sizes))
