"""The control of the SGPN cell's check (``benchmark/control.py`` reaches its
references through the oracle, which does not hold this one): the plain
reference (``reference/sgpn.py``) put in the program's place and computed
one precision lower than the configuration states, TF32 products for fp32
with TF32 off.  Its answers go through the cell's own comparison
(``traffic/serve_open_loop_sgpn.py`` ``compare``) and result line, at the
cell's sizes; a sound set of limits makes that line read
``"correct": false``.

    python3 benchmark/control_sgpn.py --workload sgpn.serve.room --seeds 11 12 13

On the card TF32 is switched on for the reference's products and
convolutions; on the CPU ``control.tf32_emulated`` rounds the operands of
every product and convolution to TF32.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control as base  # noqa: E402
from benchmark.harness import core  # noqa: E402
from benchmark.reference import plain  # noqa: E402


def control(workload: str, seed: int, device, overrides=None) -> dict:
    """The result line of one seed with the control in the program's place:
    every scene of the pool requested once, the sampled ones answered by
    the reference in TF32."""
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
    results = [None] * len(pool)
    pick = gen.sampled(ctx, which, answered, sizes)
    with torch.no_grad():
        low = gen.reference(cfg, seed, device)
        with base.lower_precision(device):
            for lo in range(0, len(pick), ctx.params["ref_block"]):
                block = pick[lo:lo + ctx.params["ref_block"]]
                for i, a in zip(block, gen.forward(low, [pool[i] for i in block], device)):
                    results[i] = {"obj_logits": a["obj"].numpy(), "rel_cls": a["rel"].numpy()}
        del low
        obs["attempted"] = len(pool)
        gen.compare(ctx, gen.reference(cfg, seed, device), pool, which, results, answered,
                    sizes, obs)
    return core.result_line(obs, {}, {}, trace=False)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sgpn.serve.room")
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
