"""The nine ``program_span`` readers on hand-made span lists: what each
reads, None on an empty buffer, in a cell of the other kind, and on a
program without spans; and a traced serving run on the CPU reporting them."""

import json

import pytest
import torch

from benchmark import run
from benchmark.harness import core
from benchmark.tests import tiny
from vlsat_tpu_torch.utils import profiling
from vlsat_tpu_torch.utils.profiling import Span

SERVE = {"serve_queue_ms.serve", "server_prepare_ms.serve", "server_step_ms.serve",
         "server_fetch_ms.serve", "server_resolve_ms.serve"}
EVAL = {"engine_input_ms.eval", "engine_step_ms.eval", "engine_fetch_ms.eval",
        "engine_assemble_ms.eval"}
MS = 1_000_000


def span(name, start_ms, end_ms, id, parent=None, **attrs):
    return Span(name, start_ms * MS, end_ms * MS, 1, id, parent, attrs, "thread")


def served():
    """Two recorded batches (ids 10, 20) and the children of a third whose
    ``serve.batch`` began before the slice (parent 30, not recorded);
    three requests waited 1, 3 and 8 ms."""
    out = [span("serve.queue", 0, 1, 1, request=0, batch=0),
           span("serve.queue", 0, 3, 2, request=1, batch=0),
           span("serve.queue", 2, 10, 3, request=2, batch=1)]
    for bid, t in ((10, 10), (20, 30)):
        out += [span("serve.batch", t, t + 20, bid, scenes=2),
                span("serve.prepare", t, t + 4, bid + 1, bid),
                span("serve.step", t + 4, t + 10, bid + 2, bid),
                span("serve.fetch", t + 10, t + 18, bid + 3, bid),
                span("serve.resolve", t + 18, t + 20, bid + 4, bid)]
    out += [span(n, 60, 70, 31 + k, 30) for k, n in enumerate(
        ("serve.prepare", "serve.step", "serve.fetch", "serve.resolve"))]
    return out


def evaluated():
    """Two group steps of 4 batches and one single batch: 9 batches."""
    out, t = [], 0
    for k, batches in enumerate((4, 4, 1)):
        out += [span("eval.input", t, t + 1, 10 * k + 1),
                span("eval.step", t + 1, t + 10, 10 * k + 2, batches=batches),
                span("eval.fetch", t + 10, t + 12, 10 * k + 3),
                span("eval.assemble", t + 12, t + 18, 10 * k + 4)]
        t += 18
    return out + [span("eval.reduce", t, t + 5, 99)]


def read(metric, kind):
    return core.load_reader(metric).read({"kind": kind}, metric)


@pytest.mark.parametrize("metric,want", [
    ("serve_queue_ms.serve", 3.0), ("server_prepare_ms.serve", 4.0),
    ("server_step_ms.serve", 6.0), ("server_fetch_ms.serve", 8.0),
    ("server_resolve_ms.serve", 2.0)])
def test_server_readers(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "spans", served)
    assert read(metric, "serve") == pytest.approx(want)
    assert read(metric, "eval") is None


@pytest.mark.parametrize("metric,want", [
    ("engine_input_ms.eval", 3 / 9), ("engine_step_ms.eval", 27 / 9),
    ("engine_fetch_ms.eval", 6 / 9), ("engine_assemble_ms.eval", 18 / 9)])
def test_engine_readers(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "spans", evaluated)
    assert read(metric, "eval") == pytest.approx(want)
    assert read(metric, "serve") is None


@pytest.mark.parametrize("metric", sorted(SERVE | EVAL))
def test_readers_find_nothing_without_spans(monkeypatch, metric):
    kind = metric.split(".")[1]
    profiling.clear()
    assert read(metric, kind) is None
    # spans of the other path only
    monkeypatch.setattr(profiling, "spans", evaluated if kind == "serve" else served)
    assert read(metric, kind) is None
    # a program that records no spans (the parent of this reader)
    monkeypatch.delattr(profiling, "spans")
    assert read(metric, kind) is None


def test_the_readers_are_the_benchmarks_program_span_metrics():
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    assert {m["name"] for m in spec["per_layer"]
            if m["source"] == "program_span"} == SERVE | EVAL | {"engine_host_ms.eval"}


def test_traced_run_on_the_cpu_reports_the_server_spans(capsys):
    """The CPU records no device time, so a traced serving run reports the
    server's counter and the five span metrics, and nothing else."""
    cell = "vlsat_mmgnet.serve.val"
    rc = run.main(tiny.args(cell, trace=1), device=torch.device("cpu"),
                  overrides=tiny.overrides(cell))
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"server_batch_fill.serve"} | SERVE
    assert line["device"]["busy_s"] == 0.0
