"""Finding a cell's files by name, the run's context, the checks that decide
``correct``, and the result line.

A cell ``<cell>`` is ``benchmark/workloads/<cell>.json``: it names its
configuration (``benchmark/configs/<config>.json``), its traffic mix and the
generator that drives it (``benchmark/traffic/<generator>.py``, a module
with ``run(ctx) -> dict``), the generator's parameters and the limits of its
checks.  A metric ``<metric>`` is read by ``benchmark/metrics/<metric>.py``,
or, where that file does not exist, by the file of the part before its
first dot (``mfu.serve`` by ``metrics/mfu.py``): a module with
``read(obs, name) -> float | None``.  Nothing needs an edit to add any of
them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "vlsat_tpu")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Path = BENCH) -> dict:
    cell = load_json(bench / "workloads" / f"{_checked(name)}.json")
    cell["name"] = name
    return cell


def load_config(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "configs" / f"{_checked(name)}.json")


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_generator(name: str, bench: Path = BENCH):
    return _module(bench / "traffic" / f"{_checked(name)}.py", f"benchmark_traffic_{name}")


def load_reader(metric: str, bench: Path = BENCH):
    for stem in (metric, metric.split(".", 1)[0]):
        path = bench / "metrics" / f"{_checked(stem)}.py"
        if path.exists():
            return _module(path, f"benchmark_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {metric!r} under {bench / 'metrics'}")


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The entries of ``BENCHMARK.json``'s ``end_to_end`` or ``per_layer``
    that the cell reports: those that list it, and those without a
    ``workloads`` list."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float

    @property
    def params(self) -> dict:
        return self.cell["params"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)

    def mark(self, what: str) -> None:
        """Log how far set-up has come (seconds since the process started)."""
        self.log(f"set-up: {what} at {time.perf_counter() - self.t_process:.2f} s")


def check(checks: list, name: str, value: float, limit: float) -> None:
    """Record one compared number beside its limit (it passes at or under
    the limit; NaN fails)."""
    checks.append({"name": name, "value": float(value), "limit": float(limit)})


def passed(c: dict) -> bool:
    return bool(np.isfinite(c["value"]) and c["value"] <= c["limit"])


def sample(candidates: np.ndarray, k: int, seed: int, salt: int, must: Optional[int] = None
           ) -> np.ndarray:
    """Up to ``k`` of ``candidates`` drawn from ``seed``, ``must`` among
    them where given."""
    rng = np.random.Generator(np.random.PCG64([seed, salt]))
    pick = rng.permutation(np.asarray(candidates))[:k]
    if must is not None and must not in pick:
        pick = np.concatenate([[must], pick[:k - 1]])
    return np.sort(pick.astype(np.int64))


def output_gaps(got: list, want: list) -> Dict[str, float]:
    """The compared numbers of a sample of scenes' outputs, ``got`` against
    ``want`` (per scene ``{"obj": object logits, "rel": predicate
    probabilities}``): the widest gap of each (``*_gap``) and the root mean
    square of the differences over every compared element (``*_rms``)."""
    out = {}
    for key, name in (("obj", "obj_logit"), ("rel", "rel_prob")):
        diffs = [(g[key].double() - w[key].double().to(g[key].device)).reshape(-1)
                 for g, w in zip(got, want)]
        d = np.concatenate([x.cpu().numpy() for x in diffs])
        out[f"{name}_gap"] = float(np.abs(d).max())
        out[f"{name}_rms"] = float(np.sqrt(np.mean(d * d)))
    return out


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def result_line(obs: dict, metrics: Dict[str, dict], device: dict, trace: bool) -> dict:
    checks = obs["checks"]
    correct = (bool(checks) and all(passed(c) for c in checks)
               and obs["failed"] == 0 and obs["attempted"] > 0)
    line = {"correct": correct, "attempted": int(obs["attempted"]), "failed": int(obs["failed"]),
            "metrics": metrics, "device": device}
    if trace and obs.get("trace"):
        line["breakdown"] = {"device_ops": obs["trace"]["device_ops"],
                             "idle_gaps": obs["trace"]["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return line
