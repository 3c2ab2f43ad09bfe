"""The benchmark is driven by its files: ``BENCHMARK.json`` names cells,
configurations and metrics whose files the harness finds by name, and a new
cell is a new file, with no edit to any file that is there."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import core
from benchmark.tests import tiny

SPEC = core.load_json(core.ROOT / "BENCHMARK.json")


def test_every_cell_file_loads_and_agrees_with_benchmark_json():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = core.load_cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert w["chips"] == 1
        assert (core.BENCH / "traffic" / f"{cell['generator']}.py").exists()
        cfg = core.load_config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert configs[cell["config"]]["file"] == f"benchmark/configs/{cell['config']}.json"
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())


def test_every_metric_has_a_reader_and_valid_names():
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert core.NAME.match(m["name"]), m["name"]
            assert hasattr(core.load_reader(m["name"]), "read")
            for cell in m.get("workloads", []):
                assert cell in {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert core.NAME.match(w["name"]) and core.NAME.match(w["traffic"])
        e2e = core.cell_metrics(SPEC, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert core.cell_metrics(SPEC, w["name"], "per_layer")


def test_a_new_cell_file_runs_in_a_copy_without_edits(tmp_path):
    """A throwaway cell (a new workload file and a BENCHMARK.json entry, in a
    copy of the benchmark) runs through the copy's unedited harness."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((core.BENCH / "workloads" / "vlsat_mmgnet.serve.val.json").read_text())
    cell["traffic"] = "serve.val_throwaway"
    cell["params"]["deadline_ms"] = 2.0  # another mix of the same generator: data only
    name = "vlsat_mmgnet.serve.val_throwaway"
    (tmp_path / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": name, "config": "vlsat_mmgnet",
                              "traffic": "serve.val_throwaway", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "serve" in m["name"]:
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = ("import sys, json, torch; sys.path.insert(0, sys.argv[1]); "
              "from benchmark import run; from benchmark.tests import tiny; "
              "o = tiny.overrides('vlsat_mmgnet.serve.val'); "
              "sys.exit(run.main(tiny.args(sys.argv[2]), device=torch.device('cpu'), "
              "overrides=o))")
    env = dict(os.environ, PYTHONPATH=str(core.ROOT), OMP_NUM_THREADS="4")
    res = subprocess.run([sys.executable, "-c", script, str(tmp_path), name], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in core.cell_metrics(spec, name, "end_to_end")}
    assert {"serve_p50_ms", "setup_s"} <= set(line["metrics"])


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the run fails."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    script = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
              "from benchmark import run; "
              "sys.exit(run.main(sys.argv[2:], device=torch.device('cpu')))")
    res = subprocess.run([sys.executable, "-c", script, str(tmp_path),
                          *tiny.args("vlsat_mmgnet.eval.val")], cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == "" or not res.stdout.strip().splitlines()[-1].startswith("{")
