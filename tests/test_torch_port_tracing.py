"""The port's spans (``utils.profiling``) on the CPU: they record only while
a ``torch.profiler`` session is active, sit in the profiler's trace on its
clock where the profiler records their thread, and cover the host time of
``serving.BatchedServer`` and ``eval.engine.evaluate``; ``trace()`` writes
the server thread's spans into its Chrome trace; a failed batch is counted.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from vlsat_tpu_torch.data.resident import ResidentGroupedEval, ResidentScenes
from vlsat_tpu_torch.data.synthetic import make_batch, make_scene
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.serving import BatchedServer, HTTPFrontend
from vlsat_tpu_torch.train.step import make_eval_step
from vlsat_tpu_torch.utils import profiling

CFG = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64, dim_node=64,
                   dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64)
KW = dict(num_points=16, feat_dim=64, num_obj_classes=20, num_rel_classes=7)
SERVE_CHILDREN = ("serve.prepare", "serve.step", "serve.fetch", "serve.resolve")
EVAL_SPANS = ("eval.input", "eval.step", "eval.fetch", "eval.assemble", "eval.reduce")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread, as ``tests/torch_threads.py`` sets it (not
    imported: this file also runs with ``--noconftest`` beside the card's
    tests, where another project's installed ``tests`` package can shadow
    this directory)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _requests(n: int, seed: int = 0) -> list:
    rng = np.random.RandomState(seed)
    sizes = rng.randint(3, 12, n)  # buckets 4, 8 and 12
    return [{k: v for k, v in make_scene(rng, int(k), **KW).items()
             if k in ("obj_points", "descriptor")} for k in sizes]


def _server(**kw) -> BatchedServer:
    return BatchedServer(build_mmgnet(CFG, device="cpu"), device="cpu", max_batch=4,
                         deadline_ms=20.0, feat_dim=64, num_rel_classes=7, **kw)


# ------------------------------------------------------------------ spans

def test_the_switch_is_the_profilers_process_global_flag():
    """``torch.autograd.profiler._is_profiler_enabled`` (private) is what
    ``span`` reads: False outside a session, True inside it on every
    thread, while the C-level flag is True only on the profiled thread."""
    seen = {}

    def worker(go, done):
        go.wait(10)
        seen["global"] = autograd_profiler._is_profiler_enabled
        seen["thread"] = torch._C._autograd._profiler_enabled()
        seen["recording"] = profiling.stamp() is not None
        done.set()

    go, done = threading.Event(), threading.Event()
    t = threading.Thread(target=worker, args=(go, done))
    t.start()
    assert autograd_profiler._is_profiler_enabled is False and profiling.stamp() is None
    with _cpu_profile():
        assert torch._C._autograd._profiler_enabled()
        go.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    assert seen == {"global": True, "thread": False, "recording": True}
    assert autograd_profiler._is_profiler_enabled is False


def test_spans_record_only_inside_a_profiler():
    with profiling.span("outside", batch=1) as sp:
        sp.set(scenes=2)
    profiling.record("outside.interval", profiling.stamp(), request=0)
    assert profiling.stamp() is None and profiling.spans() == []

    with _cpu_profile():
        t = profiling.stamp()
        with profiling.span("outer", batch=7) as sp:
            with profiling.span("inner"):
                torch.ones(2) + 1
            sp.set(scenes=3)
        profiling.record("wait", t, request=5)
        with pytest.raises(ValueError):
            with profiling.span("broken"):
                raise ValueError("no")
    with profiling.span("after"):
        pass
    got = {s.name: s for s in profiling.spans()}
    assert set(got) == {"outer", "inner", "wait", "broken"}
    outer, inner, wait = got["outer"], got["inner"], got["wait"]
    assert outer.attrs == {"batch": 7, "scenes": 3} and outer.parent is None
    assert inner.parent == outer.id and outer.start_ns <= inner.start_ns <= inner.end_ns
    assert inner.end_ns <= outer.end_ns
    assert outer.kind == inner.kind == "profiled"  # the main thread is profiled
    assert wait.kind == "interval" and wait.attrs == {"request": 5} and wait.start_ns == t
    assert got["broken"].attrs == {"error": "ValueError"}
    assert len({s.id for s in got.values()}) == 4
    assert all(s.thread == threading.get_native_id() for s in got.values())
    profiling.clear()
    assert profiling.spans() == []


def test_a_profiled_span_is_in_the_trace_on_its_clock(tmp_path):
    """A span on the profiled thread is a ``record_function`` of the
    exported trace, and its start converted to the trace's clock lies
    within 0.5 ms of that event's."""
    with _cpu_profile() as prof:
        for k in range(5):
            with profiling.span(f"probe{k}"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    events = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    for s in profiling.spans():
        ev = events[s.name]
        assert abs(profiling.trace_us(s.start_ns, base) - float(ev["ts"])) < 500.0, s.name
        assert (s.end_ns - s.start_ns) / 1e3 <= float(ev["dur"]) + 1.0


# ----------------------------------------------------------------- server

def _wait_for_batches(scenes: int) -> None:
    deadline = time.monotonic() + 60
    while sum(s.attrs["scenes"] for s in profiling.spans()
              if s.name == "serve.batch") < scenes and time.monotonic() < deadline:
        time.sleep(0.005)


def test_server_spans_cover_each_batch(tmp_path):
    """Under ``trace()``: one ``serve.queue`` a request, whose request id is
    in its batch's ``serve.batch``; the four children of each batch lie
    inside it and cover at least 95 % of it; the server thread's spans are
    in the trace's file, on that thread."""
    reqs = _requests(10)
    with _server() as server:
        server.predict(reqs[0], timeout=120)  # warm
        with profiling.trace(str(tmp_path)) as path:
            futs = [server.submit(r) for r in reqs]
            for f in futs:
                f.result(timeout=120)
            _wait_for_batches(len(reqs))  # the last batch's span closes after its futures
        worker = server._thread.native_id
    spans = profiling.spans()
    queue = [s for s in spans if s.name == "serve.queue"]
    batches = {s.id: s for s in spans if s.name == "serve.batch"}
    assert len(queue) == len(reqs) and batches
    assert len({s.attrs["request"] for s in queue}) == len(reqs)
    by_batch = {s.attrs["batch"]: s for s in batches.values()}
    for q in queue:
        assert q.attrs["request"] in by_batch[q.attrs["batch"]].attrs["requests"]
        assert q.kind == "interval" and q.end_ns >= q.start_ns
    assert sum(b.attrs["scenes"] for b in batches.values()) == len(reqs)
    for b in batches.values():
        assert {"bucket", "edges"} <= set(b.attrs) and b.kind == "thread"
        kids = [s for s in spans if s.parent == b.id]
        assert Counter(s.name for s in kids) == Counter(SERVE_CHILDREN)
        assert all(b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns for s in kids)
        covered = sum(s.end_ns - s.start_ns for s in kids)
        assert covered >= 0.95 * (b.end_ns - b.start_ns), (covered, b)
    assert all(s.thread == worker for s in spans if s.name != "serve.queue")
    events = json.loads(open(path).read())["traceEvents"]
    written = [e for e in events if e.get("cat") == "span" and e.get("ph") == "X"]
    assert {e["name"] for e in written} >= {"serve.batch", "serve.collect", *SERVE_CHILDREN}
    assert {e["tid"] for e in written} == {worker}
    assert sum(e.get("ph") == "b" and e["name"] == "serve.queue" for e in events) == len(reqs)


def test_a_failed_batch_is_counted_and_its_span_closed():
    def step(state, batch):
        raise RuntimeError("card lost")

    step.device = torch.device("cpu")
    server = BatchedServer(eval_step=step, max_batch=4, deadline_ms=1.0, feat_dim=64,
                           num_rel_classes=7)
    with HTTPFrontend(server) as fe:
        with _cpu_profile():
            fut = server.submit(_requests(1)[0])
            with pytest.raises(RuntimeError, match="card lost"):
                fut.result(timeout=60)
            _wait_for_batches(1)
        with urllib.request.urlopen(f"http://127.0.0.1:{fe.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    assert server.stats["failed"] == 1 and server.stats["batches"] == 0
    assert health["failed"] == 1 and health["batches"] == 0
    batch = [s for s in profiling.spans() if s.name == "serve.batch"]
    assert len(batch) == 1 and batch[0].attrs["error"] == "RuntimeError"


def test_many_clients_under_a_short_switch_interval_lose_no_span():
    """16 client threads submit 40 requests each into a server (a stub step)
    with the interpreter switching threads every microsecond: every request
    id is unique and has its ``serve.queue`` span, span ids are unique, and
    the batches hold every request once."""
    def step(state, batch):
        b, n, e = batch.num_scenes, batch.num_nodes, batch.num_edges
        return {"obj_logits_3d": torch.zeros(b, n, 3), "rel_cls_3d": torch.zeros(b, e, 2)}

    step.device = torch.device("cpu")
    reqs, clients, each = _requests(4), 16, 40
    server = BatchedServer(eval_step=step, max_batch=8, deadline_ms=1.0, feat_dim=64,
                           num_rel_classes=2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with server, _cpu_profile():
            def client(k):
                for i in range(each):
                    server.predict(reqs[(k + i) % len(reqs)], timeout=120)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            _wait_for_batches(clients * each)
    finally:
        sys.setswitchinterval(interval)
    spans = profiling.spans()
    queue = [s.attrs["request"] for s in spans if s.name == "serve.queue"]
    assert sorted(queue) == list(range(clients * each))
    batched = [r for s in spans if s.name == "serve.batch" for r in s.attrs["requests"]]
    assert sorted(batched) == sorted(queue)
    assert len({s.id for s in spans}) == len(spans)
    assert server.stats["scenes"] == clients * each and server.stats["failed"] == 0


# ------------------------------------------------------------- evaluation

class _Pack:
    """A packed split held in memory, one SceneBatch a bucket (what
    ``ResidentScenes`` reads of a ``PackedScenes``)."""
    text_table = None
    max_gt = None

    def __init__(self, batches):
        self._b = {b.num_nodes: b for b in batches}
        self.buckets = sorted(self._b)

    def count(self, bucket):
        return self._b[bucket].num_scenes

    def batch(self, bucket, idx, variant=0):
        return SceneBatch(**{k: None if v is None else v[idx].clone()
                             for k, v in vars(self._b[bucket]).items()})


def test_evaluate_spans_cover_the_pass():
    """``evaluate`` over a grouped resident loader, under a profiler: the
    ``eval.*`` spans of the pass cover at least 95 % of its wall time, and
    ``eval.step`` counts each batch of each group."""
    pack = _Pack([make_batch(seed=1, node_counts=(5, 3, 8, 6, 7, 4, 5), bucket=8, **KW),
                  make_batch(seed=2, node_counts=(9, 12, 10), bucket=12, **KW)])
    loader = ResidentGroupedEval(ResidentScenes(pack, device="cpu"), 2, group=2)
    model = build_mmgnet(CFG, device="cpu")
    step, state = make_eval_step(model, device="cpu"), model.state_dict()
    want = evaluate(step, state, loader, num_rel_classes=7, verbose=False)
    with _cpu_profile():
        t0 = time.perf_counter_ns()
        got = evaluate(step, state, loader, num_rel_classes=7, verbose=False)
        wall = time.perf_counter_ns() - t0
    assert got == want
    spans = profiling.spans()
    assert {s.name for s in spans} == set(EVAL_SPANS)
    assert all(s.parent is None and s.kind == "profiled" for s in spans)
    steps = [s for s in spans if s.name == "eval.step"]
    assert [s.attrs["batches"] for s in steps] == [2, 2, 2]  # 4 batches at 8, 2 at 12
    assert sum(s.name == "eval.assemble" for s in spans) == len(steps)
    covered = sum(s.end_ns - s.start_ns for s in spans)
    assert 0.95 * wall <= covered <= wall, (covered, wall)
