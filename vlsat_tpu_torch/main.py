"""CLI entry (counterpart of ``vlsat_tpu/main.py``):

    python -m vlsat_tpu_torch.main --mode {train,eval,trace,serve} --config cfg.json
                                   [--device cuda|cpu] [--data-parallel]

Loads the config (the defaults merged with the JSON; a JAX experiment JSON
loads unchanged), seeds, archives the resolved config as
``PATH/NAME/exp/config.json``, builds the ``Runner`` on ``--device`` (the
card by default; without one the run stops unless ``--device cpu`` is given)
and dispatches:

* ``train``: resume from the latest checkpoint (an unrestorable one is
  archived and training starts fresh), train, then ``validation(save=True)``;
* ``eval``: restore the latest (``--loadbest``: the best) checkpoint and
  write the metrics and artifacts under ``PATH/results/NAME/exp``;
* ``trace``: restore likewise, export the eval forward with
  ``torch.export`` at two buckets, check both programs against eager
  execution and write them under ``PATH/NAME/exp/traced``
  (``utils.export.trace_model``);
* ``serve``: restore likewise and serve ``POST /predict`` and
  ``GET /healthz`` on ``--host``/``--port`` (0 = an ephemeral port) until
  Ctrl-C.

``PRNG_IMPL`` and ``COMPILE_CACHE_DIR`` configure JAX and are ignored here.

``--data-parallel`` (train, eval) shards every batch's scenes over ranks,
one process a rank, with the JAX mesh's global-batch semantics
(``train/runner.py``):

* under torchrun (``RANK``/``WORLD_SIZE`` set) each process joins that
  group, rank r on ``cuda:LOCAL_RANK`` (gloo where ranks share a card, and
  with ``--device cpu``);
* without it, on a host with several cards, one rank a visible card is
  spawned (JAX shards over all devices) and rank 0's metrics are returned;
* with one card, or on the CPU without a launcher, it runs as one process,
  as JAX's mesh on one device.

A group that cannot form raises; a rank that fails fails the run.  Serve
and trace ignore the flag, as the JAX runner's server does.
"""

from __future__ import annotations

import argparse
import os

import torch

from vlsat_tpu_torch import parallel


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="vlsat_tpu_torch: 3D scene graph prediction "
                                            "in PyTorch")
    p.add_argument("--config", type=str, default=None, help="experiment config JSON")
    p.add_argument("--mode", type=str, choices=["train", "eval", "trace", "serve"],
                   default="train")
    p.add_argument("--exp", type=str, default="default")
    p.add_argument("--loadbest", action="store_true", help="load best (vs latest) checkpoint")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard batches over ranks: torchrun's, else one a card (one card: "
                        "no effect)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the card; 'cpu' for the CPU)")
    p.add_argument("--host", type=str, default="127.0.0.1", help="serve: bind address")
    p.add_argument("--port", type=int, default=8764, help="serve: port (0 = ephemeral)")
    p.add_argument("--max-batch", type=int, default=32, help="serve: micro-batch cap")
    p.add_argument("--deadline-ms", type=float, default=5.0,
                   help="serve: batch-formation latency budget")
    return p.parse_args(argv)


def main(argv=None):
    """Run one mode; returns the closing validation's metrics (train, eval)
    or the trace report (trace)."""
    args = parse_args(argv)
    if args.data_parallel and args.mode in ("train", "eval") and parallel.world() is None:
        if "WORLD_SIZE" in os.environ:  # torchrun's group
            parallel.init_data_parallel(device=args.device)
            try:
                return _run(args)
            finally:
                parallel.shutdown()
        cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
        if cards > 1:
            return parallel.spawn_ranks(main, cards, argv)
    return _run(args)


def _run(args):
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.utils.seeding import set_random_seed

    cfg = load_config(args.config, overrides={
        "MODE": args.mode, "exp": args.exp,
        "EVAL": args.mode == "eval", "LOADBEST": args.loadbest,
    })
    set_random_seed(cfg.SEED)

    exp_dir = os.path.join(cfg.PATH, cfg.NAME, args.exp)
    os.makedirs(exp_dir, exist_ok=True)
    w = parallel.world()
    if w is None or w.rank == 0:
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    from vlsat_tpu_torch.train.runner import Runner

    runner = Runner(cfg, data_parallel=args.data_parallel, device=args.device)
    try:
        if args.mode == "eval":
            if not runner.load(best=args.loadbest):
                print("warning: no checkpoint found, evaluating fresh init")
            return runner.validation(save=True, with_scores=True)
        if args.mode == "serve":
            if not runner.load(best=args.loadbest):
                print("warning: no checkpoint found, serving fresh init")
            frontend = runner.serve(host=args.host, port=args.port, max_batch=args.max_batch,
                                    deadline_ms=args.deadline_ms)
            print(f"serving on http://{args.host}:{frontend.port} "
                  f"(POST /predict, GET /healthz)", flush=True)
            frontend.serve_forever()
            return None
        if args.mode == "trace":
            from vlsat_tpu_torch.utils.export import trace_model

            runner.load(best=args.loadbest)
            return trace_model(runner, os.path.join(exp_dir, "traced"))
        # resume tolerantly: an unrestorable checkpoint is archived and
        # training starts fresh (reference main.py:45-48)
        runner.load(best=False, allow_fallback=True)
        runner.train()
        return runner.validation(save=True)
    finally:
        runner.close()


if __name__ == "__main__":
    main()
