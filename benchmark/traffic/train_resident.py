"""Training through the program's resident train step
(``train.step.make_resident_multi_train_step``), as the runner trains a
packed split with ``TRAIN_RESIDENT``.

The train split is ``train_scenes`` scenes whose labels cycle through the
pool of ``harness.scenes`` (``scenes``: the same multiset of node and
relation counts for every seed), packed in the program's layout and placed
on the card by its resident loader (``data.resident.ResidentScenes``).
Each step takes ``batch`` rows of one bucket, in the runner's epoch order:
buckets ascending, rows permuted within each bucket from the seed, whole
batches only.  The objective is the registry's loss of the configuration
(``lambda_o``, DYNAMIC edge weights); the optimizer is the program's AdamW
at ``lr`` with the cosine schedule over ``max_epochs`` epochs.

Set-up builds one train state and drives it through its first steps,
taking the buckets' first batches in turn (the first of each bucket, then
the second of each, ...): steps 1-3, all rows distinct, then
``warm_steps`` more, so that every bucket's shapes are warm.  The window
then runs the remaining batches of the epoch order, epoch after epoch,
until ``--seconds`` have passed, and reads the last loss back.  A traced run profiles the steps that start in the last
``trace_s`` seconds.

Correct: the reference (``reference/plain.py``: the oracle's forward, the
plain loss and AdamW written out, on the same initial weights and rows)
follows steps 1-3, and each step's loss, the first gradient (as the
program's optimizer holds it after step 1) and the parameters' change
after step 3, leaf by leaf, lie within the cell's limits.  The reference is
built from the seed once the window has closed and the program's state is
freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core, program, roofline, scenes
from benchmark.harness.trace import Profile
from benchmark.reference import plain

CHECKED = 3


def epoch_groups(rows: dict, batch: int, seed: int, epoch: int) -> list:
    """(bucket, rows) of one epoch: buckets ascending, each bucket's rows
    permuted from the seed, cut into whole batches."""
    rng = np.random.Generator(np.random.PCG64([seed, 20, epoch]))
    out = []
    for b in sorted(rows):
        perm = rng.permutation(len(rows[b])).astype(np.int32)
        out += [(b, perm[s:s + batch]) for s in range(0, len(perm) - batch + 1, batch)]
    return out


def opening_groups(rows: dict, batch: int, seed: int) -> list:
    """The set-up's batches, in order: the first epoch's batches of each
    bucket taken in turn (the first of each bucket, then the second of
    each, ...)."""
    order = epoch_groups(rows, batch, seed, 0)
    queues = [[g for g in order if g[0] == b] for b in sorted(rows)]
    return [q[i] for i in range(max(map(len, queues))) for q in queues if i < len(q)]


def leaf_map(cfg: dict, weights: dict, model) -> dict:
    """Port parameter name -> the reference parameter it was imported from:
    every leaf of ``weights`` (the checkpoint layout ``program.build``
    drew) is given a distinct constant and imported the way the weights
    were."""
    from vlsat_tpu_torch.interop import torch_import

    tag, names, layout = 1.0, {}, {}
    for child, sd in weights.items():
        layout[child] = {}
        for key, arr in sd.items():
            layout[child][key] = np.full_like(arr, tag)
            names[tag] = f"{child}.{key}"
            tag += 1.0
    variables = getattr(torch_import, cfg["import"])(layout, **cfg.get("import_kwargs", {}))
    tagged = torch_import.to_state_dict(variables, model)
    return {n: names[float(tagged[n].reshape(-1)[0])] for n, _ in model.named_parameters()}


def make_pool(ctx: core.Context) -> list:
    """The train split: ``train_scenes`` scenes made from the seed, their
    labels cycling through the pool of ``scenes``."""
    p, cfg = ctx.params, ctx.config
    base = scenes.label_specs(p["scenes"], p.get("max_nodes"))
    return scenes.make_scenes([base[i % len(base)] for i in range(p["train_scenes"])],
                              ctx.seed, num_points=cfg["num_points"], with_2d=False,
                              feat_dim=cfg["MODEL"]["clip_feat_dim"],
                              num_rel=cfg["num_rel_classes"])


def run(ctx: core.Context) -> dict:
    from vlsat_tpu_torch.data.resident import ResidentScenes
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_resident_multi_train_step

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    model, loss_fn, weights = program.build(cfg, ctx.seed, dev, ctx.mark)
    pool = make_pool(ctx)
    sizes = np.array([len(s["gt_class"]) for s in pool])
    pack = program.memory_pack(pool, feat_dim=cfg["MODEL"]["clip_feat_dim"])
    resident = ResidentScenes(pack, device=dev)
    ctx.mark(f"{len(pool)} scenes made, packed and resident")
    decay = max(int(p["max_epochs"] * len(pool) // p["batch"]), 1)
    optimizer = make_optimizer(lr=p["lr"], max_iteration=decay, schedule="Cosine")
    state = create_train_state(model, optimizer)
    objective = lambda outputs, batch: loss_fn(outputs, batch, lambda_o=p["lambda_o"],
                                               weight_mode="DYNAMIC")
    spans = program.StepSpans()
    step = spans.wrap(make_resident_multi_train_step(model, optimizer, batch_size=p["batch"],
                                                     objective=objective, device=dev))

    def call(k, group):
        b, perm = group
        return step(state, resident.full_batch(b), perm, (ctx.seed * 1000003 + k) % (1 << 62))

    order = epoch_groups(pack.rows, p["batch"], ctx.seed, 0)
    opening = opening_groups(pack.rows, p["batch"], ctx.seed)
    first, warm = opening[:CHECKED], opening[CHECKED:CHECKED + p["warm_steps"]]
    params0 = {n: t.detach().clone() for n, t in model.named_parameters()}
    losses, grads = [], None
    for k, g in enumerate(first + warm):
        _, aux = call(k, g)
        if k < CHECKED:
            losses.append(aux["loss"])
        if k == 0:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            grads = {n: (state.optimizer.state[t]["exp_avg"] / (1 - b1)).norm()
                     for n, t in model.named_parameters()
                     if t in state.optimizer.state}
        if k == CHECKED - 1:
            deltas = {n: (t.detach() - params0[n]).norm() for n, t in model.named_parameters()}
    del params0
    program.synchronize(dev)
    program.settle()
    ctx.mark("first steps done")

    used = {(b, tuple(r)) for b, r in first + warm}
    stream = [g for g in order if (g[0], tuple(g[1])) not in used]
    prof = Profile(dev)
    n_calls0 = len(spans.starts)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    steps, epoch, k = 0, 0, len(first) + len(warm)
    notes = []
    while time.perf_counter() - t0 < ctx.seconds:
        if not stream:
            epoch += 1
            stream = epoch_groups(pack.rows, p["batch"], ctx.seed, epoch)
        g = stream.pop(0)
        if ctx.trace and prof.t0 is None and time.perf_counter() - t0 >= ctx.seconds - p["trace_s"]:
            prof.start()
        _, aux = call(k, g)
        notes.append(g)
        k += 1
        steps += 1
    last_loss = float(aux["loss"])
    t_end = time.perf_counter()
    if prof.active:
        prof.stop()
    obs = {"kind": "train", "setup_s": setup_s, "window_s": t_end - t0, "steps": steps,
           "scenes": steps * p["batch"], "attempted": steps, "failed": 0,
           "memory_peak_bytes": program.memory_peak(dev), "power_limit": program.power_limit(dev),
           "peaks": roofline.peaks(torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else None),
           "checks": []}
    win = range(n_calls0, n_calls0 + steps)
    traced = [j for j in win if prof.contains(spans.starts[j])]
    untraced = [j for j in win if not prof.contains(spans.starts[j])]
    if untraced:
        obs["host_spans"] = (None, sum(spans.ends[j] - spans.starts[j] for j in untraced),
                             len(untraced))
    ctx.log(f"{ctx.cell['name']}: {steps} steps of {p['batch']} scenes in "
            f"{obs['window_s']:.3f} s, last loss {last_loss:.6f}")
    got_losses = [float(v) for v in losses]
    got_grads = {n: float(v) for n, v in grads.items()}
    got_deltas = {n: float(v) for n, v in deltas.items()}
    trained_rows = [(b, np.asarray(r)) for b, r in first]
    traced_groups = [notes[j - n_calls0] for j in traced]
    if prof.summary is not None and traced:
        obs["trace"] = prof.summary
        obs["traced_batches"] = traced_groups
    names = leaf_map(cfg, weights, model)
    del state, step, resident, model, optimizer, weights
    program.free(dev)

    plain.set_tf32(False)
    ref = program.reference(cfg, ctx.seed, dev)
    compare(ctx, ref, pool, pack.rows, trained_rows, decay, names, got_losses, got_grads,
            got_deltas, obs)
    if "trace" in obs:
        per_n = {}
        for n in np.unique(sizes):
            per_n[int(n)] = train_flops(ref, pool[int(np.flatnonzero(sizes == n)[0])], dev,
                                        p["lambda_o"])
        obs["traced_flops"] = float(sum(per_n[int(sizes[pack.rows[b][r]])]
                                        for b, rows in traced_groups for r in rows))
    return obs


def train_flops(ref, scene, dev, lambda_o) -> float:
    blk = plain.flatten([scene], dev)

    def fwd_bwd():
        loss = plain.sgfn_loss(plain.sgfn_forward(ref, blk), blk, lambda_o)
        torch.autograd.grad(loss, [t for t in ref.parameters()], allow_unused=True)

    return roofline.count_flops(fwd_bwd)


def reference_steps(ref, blocks, lr: float, decay: int, lambda_o: float) -> tuple:
    """The reference trained through ``blocks`` (one flattened batch a step):
    each step's loss, the first step's gradient norm by leaf, and each
    leaf's change over all the steps (norms).  Trains ``ref`` in place."""
    params = dict(ref.named_parameters())
    start = {n: t.detach().clone() for n, t in params.items()}
    adam = plain.AdamW(list(params.values()), lr=lr, decay_steps=decay)
    losses, grads = [], None
    for blk in blocks:
        loss = plain.sgfn_loss(plain.sgfn_forward(ref, blk), blk, lambda_o)
        g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        g = [torch.zeros_like(t) if x is None else x for t, x in zip(params.values(), g)]
        losses.append(float(loss.detach()))
        if grads is None:
            grads = {n: float(x.norm()) for n, x in zip(params, g)}
        adam.step(g)
    deltas = {n: float((t.detach() - start[n]).norm()) for n, t in params.items()}
    return losses, grads, deltas


def gaps(got: tuple, want: tuple) -> dict:
    """The compared numbers of a few train steps, ``got`` against ``want``
    (each: losses, gradient norms and change norms by reference leaf):
    the worst step's relative loss gap; by the worst leaf, the gap between
    the two norms over the larger of the reference leaf's and the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone under Adam and are left out of
    the change."""
    (gl, gg, gd), (wl, wg, wd) = got, want
    med_g = float(np.median(list(wg.values())))
    moved = [n for n in wg if wg[n] >= 1e-3 * med_g]
    med_d = float(np.median([wd[n] for n in moved]))
    grad = {n: abs(gg.get(n, 0.0) - wg[n]) / max(wg[n], med_g) for n in wg}
    update = {n: abs(gd.get(n, 0.0) - wd[n]) / max(wd[n], med_d) for n in moved}
    return {
        "loss_gap": max(core.relative_gap(a, b) for a, b in zip(gl, wl)),
        "grad_gap": max(grad.values()),
        "update_gap": max(update.values()),
        "left_out": sorted(set(wg) - set(moved)),
        "worst": {"grad": sorted(grad.items(), key=lambda kv: -kv[1])[:4],
                  "update": sorted(update.items(), key=lambda kv: -kv[1])[:4],
                  "losses": [core.relative_gap(a, b) for a, b in zip(gl, wl)]},
    }


def blocks_of(pool, pack_rows, groups, device) -> list:
    return [plain.flatten([pool[pack_rows[b][r]] for r in rows], device) for b, rows in groups]


def compare(ctx, ref, pool, rows, trained_rows, decay, names, got_losses, got_grads,
            got_deltas, obs) -> None:
    """The reference trained through the same rows (``trained_rows`` of the
    buckets' ``rows``) from the same weights, against the program's losses,
    first gradient and change (by program leaf; ``names`` maps each to its
    reference leaf)."""
    p = ctx.params

    def per_ref_leaf(values: dict) -> dict:
        sq = {}
        for n, v in values.items():
            sq[names[n]] = sq.get(names[n], 0.0) + v * v
        return {n: float(np.sqrt(v)) for n, v in sq.items()}

    want = reference_steps(ref, blocks_of(pool, rows, trained_rows, ctx.device), p["lr"],
                           decay, p["lambda_o"])
    res = gaps((got_losses, per_ref_leaf(got_grads), per_ref_leaf(got_deltas)), want)
    obs["left_out_leaves"] = res.pop("left_out")
    ctx.log(f"losses program {got_losses} reference {want[0]}; leaves left out of the "
            f"change: {obs['left_out_leaves']}; worst: {res.pop('worst')}")
    for name, value in res.items():
        core.check(obs["checks"], name, value, ctx.limits[name])
