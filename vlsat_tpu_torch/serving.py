"""Batched-queue serving loop for scene-graph prediction, and its HTTP
transport.

Counterpart of ``vlsat_tpu/serving.py`` (``BatchedServer`` :34-179,
``HTTPFrontend`` :182-291 and ``bench_server`` :294-331).  The server
micro-batches incoming scenes up to ``max_batch`` within a ``deadline_ms``
budget, pads them to a shared node bucket, narrows the batch to the wire
format, copies it to the card from pinned host memory with ``non_blocking``
(as ``eval.engine.evaluate`` does), runs one eval step and resolves each
scene's future with its unpadded predictions.  By default it runs the 3D
branch alone (the paper's deployment protocol); ``branch_3d_only=False``
runs the dual forward, whose 3D outputs are the same.

One worker thread owns every device call; the HTTP request threads only
enqueue scenes and wait on their futures.

Spans (``utils.profiling``, recorded while a profiler session is active):
``serve.queue`` a request (submit to being taken into a batch; its request
and batch ids), ``serve.collect`` a batch (first request taken to batch
closed) and ``serve.batch`` (batch id, scenes, bucket, valid edges, request
ids) with its children ``serve.prepare`` (pad, collate, wire, pin),
``serve.step`` (the step's launches enqueued; the edge rows it computed
of the batch's slots, and the batch's valid instances of its instance
slots), ``serve.fetch`` (the outputs'
copy to the host, which waits for the card) and ``serve.resolve`` (unpad,
the futures and their callbacks).
"""

from __future__ import annotations

import io
import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from vlsat_tpu_torch.data.wire import encode_wire
from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.scene import (
    DEFAULT_NODE_BUCKETS, collate, full_edge_index, pad_scene, pick_bucket)
from vlsat_tpu_torch.train.step import make_eval_step, take_edge_rows, take_instances
from vlsat_tpu_torch.utils import profiling


class BatchedServer:
    """Micro-batching inference server over ``model``'s eval step
    (``train.step.make_eval_step``) on ``device``: the card unless the
    caller passes ``device="cpu"``; or over ``eval_step``, a step of that
    signature such as a loaded serving artifact
    (``serving_export.load_serving_artifact``), on its ``device``, with no
    model.

    ``submit`` is thread-safe and returns a Future resolving to
    ``{"obj_logits": (n, C), "rel_cls": (e, R), "edge_index": (e, 2)}``
    (numpy arrays) for the scene's n valid instances and e directed edges.
    ``state`` is a ``state_dict`` for ``model`` (by default its own); it is
    copied to the device once.  ``branch_3d_only`` picks the eval step's
    forward (the 3D branch alone, a mode of ``MMGNet`` and ``SGGpoint``, or
    the dual forward) and ``branch_key``
    the branch whose outputs ("3d" or "2d") the futures carry.
    """

    def __init__(self, model=None, state: Optional[Mapping] = None, device=None,
                 max_batch: int = 32, deadline_ms: float = 5.0,
                 buckets: Sequence[int] = DEFAULT_NODE_BUCKETS,
                 feat_dim: int = 512, num_rel_classes: int = 26,
                 branch_3d_only: bool = True, branch_key: str = "3d",
                 pad_to_max: bool = True, eval_step=None):
        if (model is None) == (eval_step is None):
            raise ValueError("BatchedServer takes a model or an eval_step, not both")
        if eval_step is None:
            dev = resolve_device(device)
            self._eval = make_eval_step(model, branch_3d_only=branch_3d_only, device=dev)
            state = model.state_dict() if state is None else state
            self._state = {k: v.to(dev) for k, v in state.items()}
        else:
            dev, self._eval, self._state = eval_step.device, eval_step, None
        self._pin = dev.type == "cuda"
        self.branch_key = branch_key
        self.max_batch = max_batch
        self.deadline_s = deadline_ms / 1e3
        self.buckets = tuple(buckets)
        self.feat_dim = feat_dim
        self.num_rel_classes = num_rel_classes
        # pad every batch to max_batch scenes (all-masked rows), so each
        # bucket sees one batch shape
        self.pad_to_max = pad_to_max
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        # "failed": batches whose run raised (their clients get the error);
        # "edge_rows" of "edge_slots": the edge rows the steps computed, of
        # the padded batches' B * E (equal where a step runs dense);
        # "instances" of "instance_slots": the valid instances of their B * N
        self.stats = {"scenes": 0, "batches": 0, "batch_size_sum": 0, "failed": 0,
                      "edge_rows": 0, "edge_slots": 0, "instances": 0, "instance_slots": 0}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "BatchedServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --------------------------------------------------------------- client
    def submit(self, scene: Dict[str, np.ndarray]) -> Future:
        """scene: {"obj_points" (n, P, C) zero-meaned, "descriptor" (n, 11),
        optional "obj_2d_feats" (n, D2), optional "edge_index" (e, 2),
        by default the full directed graph}."""
        fut: Future = Future()
        self._q.put((scene, fut, next(self._request_ids), profiling.stamp()))
        return fut

    def predict(self, scene: Dict[str, np.ndarray], timeout: float = 60.0):
        return self.submit(scene).result(timeout=timeout)

    # --------------------------------------------------------------- worker
    def _collect(self) -> Tuple[int, List]:
        """Block for one request, then take more up to max_batch until the
        deadline passes; returns the batch's id and its requests."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return -1, []
        batch_id = next(self._batch_ids)
        # the wait of each request whose submit was stamped (spans on)
        profiling.record("serve.queue", first[3], request=first[2], batch=batch_id)
        items = [first]
        with profiling.span("serve.collect", batch=batch_id) as sp:
            deadline = time.monotonic() + self.deadline_s
            while len(items) < self.max_batch:
                rest = deadline - time.monotonic()
                if rest <= 0:
                    break
                try:
                    item = self._q.get(timeout=rest)
                except queue.Empty:
                    break
                profiling.record("serve.queue", item[3], request=item[2], batch=batch_id)
                items.append(item)
            sp.set(scenes=len(items))
        return batch_id, items

    def _loop(self):
        while not self._stop.is_set():
            batch_id, items = self._collect()
            if not items:
                continue
            try:
                self._run_batch(batch_id, items)
            except Exception as e:  # the clients get the error
                self.stats["failed"] += 1
                for _, fut, _, _ in items:
                    if not fut.done():
                        fut.set_exception(e)

    def _run_batch(self, batch_id: int, items):
        scenes, futs, requests, _ = zip(*items)
        with profiling.span("serve.batch", batch=batch_id, scenes=len(items),
                            requests=requests) as sp:
            with profiling.span("serve.prepare"):
                counts = [s["obj_points"].shape[0] for s in scenes]
                bucket = pick_bucket(max(counts), self.buckets)
                padded, eis, edges = [], [], 0
                for s in scenes:
                    n = s["obj_points"].shape[0]
                    ei = np.asarray(s.get("edge_index", full_edge_index(n)), np.int32)
                    eis.append(ei)
                    edges += len(ei)
                    padded.append(pad_scene(
                        np.asarray(s["obj_points"], np.float32),
                        np.asarray(s["descriptor"], np.float32),
                        np.asarray(s.get("obj_2d_feats",
                                         np.zeros((n, self.feat_dim), np.float32)), np.float32),
                        np.zeros((n,), np.int32),
                        ei, np.zeros((len(ei), self.num_rel_classes), np.float32),
                        n_max=bucket, feat_dim=self.feat_dim,
                    ))
                sp.set(bucket=bucket, edges=edges)
                if self.pad_to_max:
                    while len(padded) < self.max_batch:
                        padded.append({k: np.zeros_like(v) for k, v in padded[0].items()})
                batch = encode_wire(collate(padded))
                if self._pin:  # the eval step's copy to the card is then asynchronous
                    batch = batch.replace(**{k: v.pin_memory() for k, v in vars(batch).items()
                                             if v is not None})
            with profiling.span("serve.step") as st:  # the host enqueues the step's launches
                take_edge_rows()
                take_instances()
                out = self._eval(self._state, batch)
                # None from an exported artifact, which runs dense
                rows, slots = take_edge_rows() or (batch.edge_mask.numel(),) * 2
                insts, inst_slots = take_instances() or (int(batch.obj_mask.sum()),
                                                         batch.obj_mask.numel())
                st.set(edge_rows=rows, edge_slots=slots, instances=insts,
                       instance_slots=inst_slots)
            with profiling.span("serve.fetch"):  # waits for the card, then copies
                ol = out[f"obj_logits_{self.branch_key}"].cpu().numpy()
                rc = out[f"rel_cls_{self.branch_key}"].cpu().numpy()
            with profiling.span("serve.resolve"):
                self.stats["scenes"] += len(items)
                self.stats["batches"] += 1
                self.stats["batch_size_sum"] += len(items)
                self.stats["edge_rows"] += rows
                self.stats["edge_slots"] += slots
                self.stats["instances"] += insts
                self.stats["instance_slots"] += inst_slots
                for k, (fut, n, ei) in enumerate(zip(futs, counts, eis)):
                    fut.set_result({"obj_logits": ol[k, :n], "rel_cls": rc[k, :len(ei)],
                                    "edge_index": ei})


class HTTPFrontend:
    """HTTP transport over a :class:`BatchedServer` (stdlib
    ``ThreadingHTTPServer``: each request thread blocks on its scene's
    future while the server micro-batches across threads).

    * ``POST /predict``: the body is an ``.npz`` with ``obj_points`` (n, P, C)
      zero-meaned, ``descriptor`` (n, 11), optional ``obj_2d_feats`` (n, D2)
      and ``edge_index`` (e, 2); the answer is an ``.npz`` with
      ``obj_logits`` (n, C_obj), ``rel_cls`` (e, R) and ``edge_index`` (e, 2).
      A payload that cannot be served gets 400 and
      ``{"error": "<Type>: <message>"}``.
    * ``GET /healthz``: JSON ``{"ok": true, "scenes", "batches",
      "mean_batch_size", "failed"}`` (``failed``: batches whose run raised).
    * Any other path: 404.

    ``port=0`` binds an ephemeral port; ``.port`` holds the bound one.
    """

    def __init__(self, server: BatchedServer, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = 120.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/healthz":
                    self._reply(404, b'{"error": "not found"}', "application/json")
                    return
                st = frontend.server.stats
                body = json.dumps({
                    "ok": True, "scenes": st["scenes"], "batches": st["batches"],
                    "mean_batch_size": st["batch_size_sum"] / max(st["batches"], 1),
                    "failed": st["failed"],
                }).encode()
                self._reply(200, body, "application/json")

            def do_POST(self):
                if self.path != "/predict":
                    self._reply(404, b'{"error": "not found"}', "application/json")
                    return
                try:
                    raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                        scene = {k: z[k] for k in z.files}
                    if "obj_points" not in scene or "descriptor" not in scene:
                        raise ValueError("payload needs obj_points and descriptor")
                    res = frontend.server.predict(scene, timeout=frontend.timeout_s)
                    buf = io.BytesIO()
                    np.savez(buf, **res)
                    self._reply(200, buf.getvalue(), "application/octet-stream")
                except Exception as e:  # the client gets the reason
                    self._reply(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(), "application/json")

        class Server(ThreadingHTTPServer):
            # the listen backlog (socketserver's default is 5): closed-loop
            # load opens one connection per client at once
            request_queue_size = 128

        self.server = server
        self.timeout_s = timeout_s
        self.httpd = Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HTTPFrontend":
        self.server.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.server.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def serve_forever(self):
        """Foreground entry of the CLI's serve mode; Ctrl-C (SIGINT) stops it."""
        self.server.start()
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.httpd.server_close()
            self.server.stop()


def bench_server(server: BatchedServer, scenes: Sequence[dict],
                 duration_s: float = 5.0, clients: int = 4) -> Dict[str, float]:
    """Closed-loop load test: ``clients`` threads submit scenes back to back
    for ``duration_s``; reports sustained scenes/s and per-request latency
    percentiles (batch formation + device + result distribution)."""
    lat: List[float] = []
    lock = threading.Lock()
    stop = time.monotonic() + duration_s
    done = [0]

    def client(i):
        rng = np.random.RandomState(i)
        local = []
        while time.monotonic() < stop:
            s = scenes[int(rng.randint(len(scenes)))]
            t0 = time.monotonic()
            server.predict(s)
            local.append(time.monotonic() - t0)
        with lock:
            lat.extend(local)
            done[0] += len(local)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    arr = np.asarray(lat) * 1e3
    return {
        "scenes_per_sec": done[0] / wall,
        "p50_latency_ms": float(np.percentile(arr, 50)) if len(arr) else float("nan"),
        "p99_latency_ms": float(np.percentile(arr, 99)) if len(arr) else float("nan"),
        "mean_batch_size": (server.stats["batch_size_sum"] /
                            max(server.stats["batches"], 1)),
        "requests": done[0],
    }
