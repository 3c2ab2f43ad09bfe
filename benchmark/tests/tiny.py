"""Small settings of every cell for CPU runs: the configurations at depth 1
(every width as published), a short window and few scenes."""

import copy

from benchmark.harness import core

PARAMS = {
    "serve_open_loop": {"rate": 12, "max_batch": 4, "sample": 6, "ref_block": 4, "grace_s": 20,
                        "trace_s": 1},
    "eval_passes": {"max_scenes": 12, "warm_passes": 1, "sample": 6, "ref_block": 32,
                    "trace_s": 1, "batch": 8, "group": 2},
    "train_resident": {"train_scenes": 300, "warm_steps": 2, "trace_s": 1},
}
CELLS = ("vlsat_mmgnet.serve.val", "sgfn.train.val", "vlsat_mmgnet.eval.val",
         "vlsat_mmgnet.serve.room")  # the cells of BENCHMARK.json and the training cell


def overrides(cell: str, depth: int = 1) -> dict:
    c = core.load_cell(cell)
    cfg = core.load_config(c["config"])
    ref = copy.deepcopy(cfg["reference"])
    ref["kwargs"]["depth"] = depth
    params = dict(PARAMS[c["generator"]])
    if cell.endswith("room"):
        params.update(max_nodes=16, rate=4)
    return {"config": {"MODEL": dict(cfg["MODEL"], N_LAYERS=depth), "reference": ref,
                       "import_kwargs": dict(cfg["import_kwargs"], depth=depth)},
            "params": params}


def args(cell: str, seed: int = 3000000001, seconds: float = 2.0, trace: int = 0) -> list:
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]

TRAIN = "sgfn.train.val"


def spec(cell: str) -> dict:
    """``BENCHMARK.json``, with the training cell and its metrics added where
    ``cell`` is that cell: it is kept out of the benchmark (``PERF.md``, Open
    questions: the program's LayerNorm epsilon) and its generator is tested
    here."""
    out = core.load_json(core.ROOT / "BENCHMARK.json")
    if cell == TRAIN:
        out["configs"].append({"name": "sgfn", "file": "benchmark/configs/sgfn.json"})
        out["workloads"].append({"name": TRAIN, "config": "sgfn", "traffic": "train.val",
                                 "chips": 1})
        out["end_to_end"].append({"name": "train_scenes_per_s", "unit": "scenes/s",
                                  "workloads": [TRAIN]})
        for m in ("step_host_ms.train", "model_busy_ms.train", "device_idle.train",
                  "mfu.train"):
            out["per_layer"].append({"name": m, "unit": "%", "workloads": [TRAIN]})
        for m in out["end_to_end"]:
            if m["name"] == "setup_s":
                m.pop("workloads", None)
    return out
