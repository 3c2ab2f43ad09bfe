"""A small CPU run of every cell's path, through ``run.main`` with the look
for a card skipped, ends in the result line of the contract."""

import json

import pytest
import torch

from benchmark import run
from benchmark.harness import core
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_runs_on_the_cpu(cell, capsys):
    rc = run.main(tiny.args(cell), device=torch.device("cpu"), overrides=tiny.overrides(cell),
                  spec=tiny.spec(cell))
    assert rc == 0
    line = last_line(capsys)
    assert list(line) == KEYS
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in core.cell_metrics(tiny.spec(cell), cell, "end_to_end")}
    assert set(line["metrics"]) == want
    assert "setup_s" in line["metrics"]
    assert core.forbidden_modules() == []


def test_traced_run_reports_per_layer_metrics_without_a_card(capsys):
    cell = "vlsat_mmgnet.serve.val"
    rc = run.main(tiny.args(cell, trace=1), device=torch.device("cpu"),
                  overrides=tiny.overrides(cell))
    assert rc == 0
    line = last_line(capsys)
    assert list(line)[-1] == "checks" and line["correct"] is True
    # the CPU records no device time: only the server's counter is reported
    assert set(line["metrics"]) == {"server_batch_fill.serve"}
    assert line["device"]["busy_s"] == 0.0


def test_no_card_means_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(tiny.args("vlsat_mmgnet.eval.val")) == 2
    assert capsys.readouterr().out == ""
