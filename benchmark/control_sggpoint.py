"""The control of the SGGpoint cell's check (``benchmark/control.py`` reaches
its references through the oracle, which does not hold this one): the
plain reference (``reference/sggpoint.py``) put in the program's place and
computed one precision lower than the configuration states, TF32 products
for fp32 with TF32 off, with its own kNN sets in the place of the
program's.  Its answers, sets and stage inputs go through the cell's own
comparison (``traffic/serve_open_loop_sggpoint.py`` ``compare``) and result
line, at the cell's sizes; a sound set of limits makes that line read
``"correct": false``.

    python3 benchmark/control_sggpoint.py --workload sggpoint.serve.room --seeds 11 12 13

On the card TF32 is switched on for the reference's products and
convolutions; on the CPU ``tf32_emulated`` rounds the operands of every
product and convolution (2D ones too, the DGCNN's) to TF32.  The
benchmark's own runs never run the control.
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

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control as base  # noqa: E402
from benchmark.harness import core  # noqa: E402
from benchmark.reference import plain  # noqa: E402


class tf32_emulated(base.tf32_emulated):
    PRODUCTS = {**base.tf32_emulated.PRODUCTS, F.conv2d: 2}


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


def control(workload: str, seed: int, device, overrides=None) -> dict:
    """The result line of one seed with the control in the program's place:
    every scene of the pool requested once, the sampled ones answered by
    the reference in TF32 on its own kNN sets, which stand for the
    program's recorded sets and stage inputs (its replay answers as it
    answered)."""
    cell = core.load_cell(workload)
    cfg = core.load_config(cell["config"])
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    cell["params"].update(overrides.get("params", {}))
    cell["limits"].update(overrides.get("limits", {}))
    ctx = core.Context(cell=cell, config=cfg, seed=seed, seconds=0.0, trace=False,
                       device=device, t_process=0.0)
    gen = core.load_generator(cell["generator"])
    plain.set_tf32(False)
    obs = {"checks": [], "failed": 0, "attempted": 0}
    pool = gen.make_pool(ctx)
    sizes = np.array([len(s["gt_class"]) for s in pool])
    which, answered = np.arange(len(pool)), np.ones(len(pool), bool)
    results, replays = [None] * len(pool), {}
    pick = gen.sampled(ctx, which, answered, sizes)
    with torch.no_grad():
        low = gen.reference(cfg, seed, device)
        with lower_precision(device):
            for i in pick:
                blk = plain.flatten([pool[i]], device)
                seen = []
                res = low.head_3d(low.backbone_3d(blk["obj_points"], record=seen), blk)
                answer = {"obj_logits": res["obj_logits_3d"].cpu().numpy(),
                          "rel_cls": res["rel_cls_3d"].cpu().numpy()}
                results[i] = answer
                replays[int(i)] = {"answer": answer,
                                   "inputs": [x.transpose(1, 2).cpu() for x, _ in seen],
                                   "sets": [s.cpu() for _, s in seen]}
        del low
        obs["attempted"] = len(pool)
        gen.compare(ctx, gen.reference(cfg, seed, device), pool, which, results, replays, obs)
    return core.result_line(obs, {}, {}, trace=False)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sggpoint.serve.room")
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
