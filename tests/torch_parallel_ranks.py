"""Rank-side cases of tests/test_torch_port_parallel.py and of the
data-parallel check in tests/test_torch_port_cuda.py.

``run`` executes in every process of a group started by
``vlsat_tpu_torch.parallel.spawn_ranks``; it imports torch and the port
only.  Rank 0 returns the results, and each case also records whether
every rank computed the same numbers (``agree``).  ``train`` runs in the
test process too, without a group, as the dp=1 reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from vlsat_tpu_torch import parallel
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.models.layers import Dropout
from vlsat_tpu_torch.train.optim import make_optimizer
from vlsat_tpu_torch.train.state import create_train_state
from vlsat_tpu_torch.train.step import make_eval_step, make_train_step


class SGD:
    """Plain SGD in the spec interface of ``make_optimizer``'s result."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, model):
        opt = torch.optim.SGD(model.parameters(), lr=self.lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 1.0)

    update = staticmethod(lambda optimizer, scheduler: (optimizer.step(), scheduler.step()))


def build(spec: dict, device="cpu"):
    """The spec's model with its weights, dropout off unless asked for."""
    model = spec["model_cls"](spec["cfg"])
    model.load_state_dict(spec["state"])
    if not spec.get("dropout", False):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model.to(device)


def train(spec: dict, world=None, device="cpu") -> dict:
    """``spec["batches"]`` through one train step each (seed ``i``) from the
    spec's weights: the steps' losses and aux, the parameters and buffers
    after the first step and after the last."""
    model = build(spec, device)
    opt = SGD(spec["lr"]) if spec["opt"] == "sgd" else make_optimizer(lr=spec["lr"],
                                                                      max_iteration=50)
    state = create_train_state(model, opt)
    loss = spec["loss"]
    step = make_train_step(model, opt, objective=lambda o, b: loss(o, b), device=device,
                           world=world)
    weights = lambda: {k: v.detach().cpu().numpy().copy()
                       for k, v in model.state_dict().items()}
    losses, auxes = [], []
    for i, b in enumerate(spec["batches"]):
        state, aux = step(state, b, i)
        losses.append(float(aux["loss"]))
        auxes.append({k: float(v) for k, v in aux.items() if v.dim() == 0})
        if i == 0:
            first = weights()
    return {"losses": losses, "aux": auxes, "state_first": first, "state": weights()}


def _replay(outs: list, world):
    """An eval step that returns precomputed outputs, rank r taking its
    block of scenes of each batch's outputs."""
    it = iter(outs)

    def step(state, batch):
        n = batch.num_scenes
        lo = 0 if world is None else world.rank * n
        return {k: torch.from_numpy(v[lo:lo + n].copy()) for k, v in next(it).items()}

    step.device = "cpu"
    return step


def _same(a, b) -> bool:
    """Equality of nested dicts, lists, arrays and numbers, NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def _agree(world, value) -> bool:
    """Whether every rank holds the same ``value``."""
    got = _gather(world, value)
    return all(_same(g, got[0]) for g in got)


def _gather(world, value) -> list:
    """Every rank's ``value``, in rank order."""
    got = [None] * world.size
    dist.all_gather_object(got, value, group=world.host_group)
    return got


def _launches() -> tuple:
    """The process's kernel launches so far: (segment-max, PointNet); both
    count card launches only."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max

    return segment_max.launches, pointnet_kernel.launches


def counted(step):
    """``step`` counting its calls (one a batch, or a grouped loader's row)."""
    def run(state, batch):
        run.calls += 1
        return step(state, batch)

    run.calls, run.device = 0, step.device
    return run


def run(inputs_path: str) -> dict:
    torch.set_num_threads(2)
    w = parallel.world()
    inp = torch.load(inputs_path, weights_only=False)
    out = {"world": (w.size, w.backend, str(w.device))}
    for name, spec in inp.get("train", {}).items():
        r = train(spec, world=w, device=w.device)
        out[f"train/{name}"] = {**r, "agree": _agree(w, r)}
    ev = inp.get("eval")
    if ev is not None:
        from vlsat_tpu_torch.data.packed import PackedLoader, PackedScenes
        from vlsat_tpu_torch.data.resident import ResidentShardedEval

        kw = dict(ev["kw"], verbose=False)
        if "outs" in ev:
            save = os.path.join(ev["work"], f"replay_rank{w.rank}")
            loader = parallel.shard_eval_batches(ev["batches"], w)
            out["eval/replay"] = evaluate(_replay(ev["outs"], w), {}, loader, save_dir=save,
                                          with_scores=True, **kw)
            out["eval/replay_files"] = sorted(os.listdir(save)) if os.path.isdir(save) else []
        model = build(ev["model"], w.device)
        step = counted(make_eval_step(model, device=w.device))
        sd = model.state_dict()
        packed = PackedScenes(ev["pack"])
        loaders = {
            "model": parallel.shard_eval_batches(ev["batches"], w),
            "streamed_pack": parallel.shard_eval_batches(PackedLoader(packed, ev["bs"]), w),
            **{f"resident_group{g}": ResidentShardedEval(packed, w, ev["bs"], group=g)
               for g in (1, 2)}}
        launches = {}
        for name, loader in loaders.items():
            # with ``save_ranks`` rank 0 writes each evaluation's rank lists
            save = os.path.join(ev["work"], name) if ev.get("save_ranks") else None
            before = (step.calls, *_launches())
            out[f"eval/{name}"] = evaluate(step, sd, loader, save_dir=save, **kw)
            launches[name] = [b - a for a, b in zip(before, (step.calls, *_launches()))]
        out["eval/agree"] = _agree(w, {k: v for k, v in out.items()
                                       if k.startswith("eval/") and k != "eval/replay_files"})
        out["launches"] = _gather(w, launches)
    cli = inp.get("cli")
    if cli is not None:  # (train JSON, eval JSON)
        from vlsat_tpu_torch.main import main

        flags = ["--data-parallel", "--device", w.device.type]
        out["cli/train"] = main(["--config", cli[0], "--mode", "train"] + flags)
        out["cli/eval"] = main(["--config", cli[1], "--mode", "eval"] + flags)
        out["cli/agree"] = _agree(w, (out["cli/train"], out["cli/eval"]))
    return out
