"""Convert a JAX training run's orbax checkpoints into the PyTorch port's.

    python tools/flax_ckpt_to_torch.py --config cfg.json --out OUT [--exp default]

The experiment JSON is the one the JAX run was trained with (it loads
unchanged in both packages).  Every step that the JAX ``CheckpointManager``
keeps under ``PATH/NAME/<exp>/checkpoints`` (the latest ones, the best one
and the unscored ones) is restored, carried across with
``vlsat_tpu_torch.interop.from_flax.train_state_from_flax`` (weights,
BatchNorm statistics, the AdamW moments and counts of every group, the
schedule at the step) and saved with its ``eva_res`` by the port's
``CheckpointManager`` under ``OUT/NAME/<exp>/checkpoints``.  The carried
state takes flax's LayerNorm epsilon (1e-6) with the weights; a port run
that loads the saved steps builds the registry's, the original's 1e-5.
Run the port on them with ``PATH`` set to ``OUT``, e.g.
``python -m vlsat_tpu_torch.main --config cfg.json --mode eval --loadbest``
after setting ``"PATH": OUT`` in the JSON.

Both runners are built from the JSON, on the CPU: the optimizer and its
schedule depend on the train split's length, so the dataset's label files
and splits must be where the JSON says.  The restore template is a fresh
``vlsat_tpu.train.state.create_train_state`` of the JAX runner's model and
optimizer on one validation batch, and the steps are read with orbax's own
``CheckpointManager``.  This tool imports both packages; the port itself
never imports JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(config: str, out: str, exp: str = "default") -> List[Tuple[int, Optional[float]]]:
    """Convert every kept step; returns [(step, eva_res or None)] in step
    order.  Raises when the JAX run has no checkpoint."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    from vlsat_tpu.config import load_config as jax_load_config
    from vlsat_tpu.data.dataset import SceneLoader
    from vlsat_tpu.train.runner import Runner as JaxRunner
    from vlsat_tpu.train.state import create_train_state
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.interop.from_flax import train_state_from_flax
    from vlsat_tpu_torch.train.runner import Runner

    over = {"MODE": "train", "exp": exp}
    jr = JaxRunner(jax_load_config(config, overrides=over))
    pr = Runner(load_config(config, overrides={**over, "PATH": out}), device="cpu")
    mgr = ocp.CheckpointManager(os.path.join(jr.exp_dir, "checkpoints"))
    try:
        steps = sorted(mgr.all_steps())
        if not steps:
            raise FileNotFoundError(f"no JAX checkpoint under {jr.exp_dir}/checkpoints")
        example = next(iter(SceneLoader(jr.valid_scenes, batch_size=1, shuffle=False)))
        template = create_train_state(jr.model, example, jr.optimizer, seed=jr.cfg.SEED)
        tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
        done = []
        for step in steps:
            js = mgr.restore(step, args=ocp.args.StandardRestore(template))
            eva_res = (mgr.metrics(step) or {}).get("eva_res")
            state = train_state_from_flax(tree(js.params), tree(js.batch_stats),
                                          tree(js.opt_state), int(js.step), model=pr.model,
                                          optimizer=pr.optimizer)
            pr.ckpt.save(state, eva_res)
            done.append((int(js.step), None if eva_res is None else float(eva_res)))
        return done
    finally:
        mgr.close()
        jr.close()
        pr.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="the JAX run's experiment JSON")
    ap.add_argument("--out", required=True, help="PATH root of the port's checkpoints")
    ap.add_argument("--exp", default="default")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")  # the conversion needs no accelerator
    for step, eva_res in convert(args.config, args.out, args.exp):
        print(f"step {step}: eva_res {eva_res}")


if __name__ == "__main__":
    main()
