"""The control of each cell's correctness check: the reference put in the
program's place and computed one precision lower than the configuration
states (TF32 matrix products for fp32 with TF32 off).  Its outputs go
through the cell's own comparison (the generator's ``compare``) and result
line (``core.result_line``) in place of what the program produced, at the
cell's sizes; a sound set of limits makes that line read ``"correct":
false``.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--out out/control.json]

On the card the control switches TF32 on for the reference's matrix
products and convolutions.  On the CPU, which has no TF32, ``tf32_emulated``
rounds the operands of every forward matrix product and convolution to
TF32 (10 mantissa bits, round to nearest) and multiplies them in fp32, as
the tensor cores do; the benchmark's tests use it.  The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import core, program  # noqa: E402
from benchmark.reference import plain  # noqa: E402


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits (to nearest); the
    gradient passes straight through (the backward products stay fp32)."""
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    return x + (((bits + 0x1000) & ~0x1FFF).view(torch.float32) - x).detach()


class tf32_emulated(TorchFunctionMode):
    PRODUCTS = {F.linear: 2, F.conv1d: 2, torch.matmul: 2, torch.Tensor.__matmul__: 2,
                torch.bmm: 2, torch.mm: 2}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n = self.PRODUCTS.get(func)
        if n:
            args = tuple(to_tf32(a) if i < n and isinstance(a, torch.Tensor) else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextlib.contextmanager
def lower_precision(device):
    if device.type == "cuda":
        plain.set_tf32(True)
        try:
            yield
        finally:
            plain.set_tf32(False)
    else:
        with tf32_emulated():
            yield


def serve(ctx, gen, obs) -> None:
    """Every scene of the pool requested once; the sampled requests answered
    by the reference in TF32, as the server hands its answers back."""
    dev = ctx.device
    pool = gen.make_pool(ctx)
    sizes = np.array([len(s["gt_class"]) for s in pool])
    which, answered = np.arange(len(pool)), np.ones(len(pool), bool)
    low, results = program.reference(ctx.config, ctx.seed, dev), [None] * len(pool)
    pick = gen.sampled(ctx, which, answered, sizes)
    with lower_precision(dev):
        for lo in range(0, len(pick), ctx.params["ref_block"]):
            block = pick[lo:lo + ctx.params["ref_block"]]
            blk = plain.flatten([pool[i] for i in block], dev)
            res = plain.mmgnet_3d(low, blk)
            for j, i in enumerate(block):
                (a, b), (c, d) = blk["nodes"][j], blk["edges"][j]
                results[i] = {"obj_logits": res["obj_logits_3d"][a:b].cpu().numpy(),
                              "rel_cls": res["rel_cls_3d"][c:d].cpu().numpy()}
    obs["attempted"] = len(pool)
    gen.compare(ctx, program.reference(ctx.config, ctx.seed, dev), pool, which, results,
                answered, sizes, obs)


def evaluate(ctx, gen, obs) -> None:
    """The split's step outputs from the reference's dual forward in TF32,
    one scene a call, and the metric dict of one pass over them."""
    dev = ctx.device
    pool = gen.make_pool(ctx)
    low = program.reference(ctx.config, ctx.seed, dev)
    with lower_precision(dev):
        outs = [plain.mmgnet_dual(low, plain.flatten([s], dev)) for s in pool]
    outputs = lambda i: outs[i]
    obs["attempted"] = len(pool)
    gen.compare(ctx, program.reference(ctx.config, ctx.seed, dev), pool, outputs,
                [gen.plain_metrics(ctx, pool, outputs)], obs)


def train(ctx, gen, obs) -> None:
    """The reference trained in TF32 through the set-up's first steps."""
    p, dev = ctx.params, ctx.device
    pool = gen.make_pool(ctx)
    rows = program.bucket_rows([len(s["gt_class"]) for s in pool])
    first = gen.opening_groups(rows, p["batch"], ctx.seed)[:gen.CHECKED]
    decay = max(int(p["max_epochs"] * len(pool) // p["batch"]), 1)
    low = program.reference(ctx.config, ctx.seed, dev)
    with lower_precision(dev):
        losses, grads, deltas = gen.reference_steps(low, gen.blocks_of(pool, rows, first, dev),
                                                    p["lr"], decay, p["lambda_o"])
    obs["attempted"] = gen.CHECKED
    gen.compare(ctx, program.reference(ctx.config, ctx.seed, dev), pool, rows, first, decay,
                {n: n for n in grads}, losses, grads, deltas, obs)


KINDS = {"serve_open_loop": serve, "eval_passes": evaluate, "train_resident": train}


def control(workload: str, seed: int, device, overrides=None) -> dict:
    """The result line of one seed with the control in the program's place:
    the cell's comparison of the control's outputs, each number beside its
    limit under ``checks``."""
    cell = core.load_cell(workload)
    cfg = core.load_config(cell["config"])
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    cell["params"].update(overrides.get("params", {}))
    cell["limits"].update(overrides.get("limits", {}))
    ctx = core.Context(cell=cell, config=cfg, seed=seed, seconds=0.0, trace=False,
                       device=device, t_process=0.0)
    plain.set_tf32(False)
    obs = {"checks": [], "failed": 0, "attempted": 0}
    grad = cell["generator"] == "train_resident"
    with contextlib.nullcontext() if grad else torch.no_grad():
        KINDS[cell["generator"]](ctx, core.load_generator(cell["generator"]), obs)
    return core.result_line(obs, {}, {}, trace=False)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    rows = []
    for seed in args.seeds:
        res = {"seed": seed, **control(args.workload, seed, dev)}
        rows.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "device": str(dev),
                                              "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
