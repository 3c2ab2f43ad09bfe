"""Batched serving demo and load test (the port's twin of
``tools/serve.py``): the micro-batching server against the naive per-scene
dispatch loop.

Usage:
    python -m vlsat_tpu_torch.tools.serve [--duration 5] [--clients 8]
        [--max-batch 32] [--deadline-ms 5] [--full-branch] [--naive] [--http]
        [--ckpt DIR] [--export-artifact DIR | --artifact DIR]
        [--sweep [--sweep-clients 1 2 4 ...] [--deadline-p99-ms 150]]
        [--out result.json] [--device cpu]

Starts a ``BatchedServer`` over the full-width flagship model
(``build_mmgnet(MMGNetConfig(), seed=0)``; ``--ckpt`` loads the best
weights of a checkpoint directory of ``train.checkpoint.CheckpointManager``,
as the runner or ``tools/flax_ckpt_to_torch.py`` write it), drives it
closed-loop from N client threads with synthetic 3DSSG-shaped scenes and
prints sustained scenes/s and latency percentiles as JSON.  ``--http``
drives the same load through ``serving.HTTPFrontend`` (npz bodies);
``--naive`` also measures a per-scene loop at B=1 padded to 16 nodes;
``--sweep`` measures the scenes/s against p50/p99 curve over the client
counts of ``--sweep-clients``, its knee and the operating point within
``--deadline-p99-ms``.  ``--export-artifact DIR`` writes a ``torch.export``
serving artifact (buckets 12 and 16, ``--max-batch`` scenes) and exits;
``--artifact DIR`` serves one (its manifest sets the batch and buckets).
Everything runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np

POOL_NODES = (9, 11, 12, 13, 14, 15, 16, 10)  # 9-16-node scenes: buckets 12 and 16
ARTIFACT_BUCKETS = (12, 16)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--deadline-ms", type=float, default=5.0)
    ap.add_argument("--full-branch", action="store_true",
                    help="run the full dual-branch model instead of the 3D branch alone")
    ap.add_argument("--naive", action="store_true",
                    help="also measure the per-scene dispatch loop")
    ap.add_argument("--http", action="store_true",
                    help="also measure through the HTTP frontend (full transport: npz "
                         "encode + POST + decode)")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint directory of train.checkpoint.CheckpointManager "
                         "(its best, else latest, weights)")
    ap.add_argument("--export-artifact", type=str, default=None,
                    help="write a torch.export serving artifact (weights inside) to this "
                         "directory and exit")
    ap.add_argument("--artifact", type=str, default=None,
                    help="serve from a saved artifact instead of the live model "
                         "(serving_export.py)")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep offered load (closed-loop clients) and report the scenes/s "
                         "vs p50/p99 curve, the knee and the deadline-bounded operating point")
    ap.add_argument("--sweep-clients", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 64, 128])
    ap.add_argument("--deadline-p99-ms", type=float, default=150.0,
                    help="p99 budget that defines the operating point reported by --sweep")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the result JSON to this path")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (the card by default; cpu for smoke tests)")
    return ap.parse_args(argv)


def request_pool() -> List[Dict[str, np.ndarray]]:
    """The 8 request scenes, 9-16 nodes at 128 points, drawn as the JAX
    tool draws them (``np.random.RandomState(0)``, ``make_scene``)."""
    from vlsat_tpu_torch.data.synthetic import make_scene

    rng = np.random.RandomState(0)
    scenes = []
    for n in POOL_NODES:
        s = make_scene(rng, n, num_points=128)
        scenes.append({k: s[k] for k in ("obj_points", "descriptor", "obj_2d_feats")})
    return scenes


def load_served(args):
    """What the tool serves: the artifact of ``--artifact`` (an
    ``ExportedEvalStep``; its manifest sets ``args.max_batch``) or the
    full-width model on ``--device`` with ``--ckpt``'s best weights."""
    from vlsat_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.artifact:
        from vlsat_tpu_torch.serving_export import load_serving_artifact

        step = load_serving_artifact(args.artifact, dev)
        args.max_batch = step.manifest["max_batch"]
        return step
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet

    model = build_mmgnet(MMGNetConfig(), dev, seed=0)
    if args.ckpt:
        from vlsat_tpu_torch.train.checkpoint import CheckpointManager

        if not CheckpointManager(args.ckpt).restore_model(model, best=True):
            raise FileNotFoundError(f"no checkpoint in {args.ckpt}")
    return model


def build_server(args, served=None):
    """A ``BatchedServer`` over ``served`` (by default ``load_served(args)``)
    with the tool's batch, deadline and buckets; not started."""
    from vlsat_tpu_torch.scene import DEFAULT_NODE_BUCKETS
    from vlsat_tpu_torch.serving import BatchedServer

    served = load_served(args) if served is None else served
    kw = dict(max_batch=args.max_batch, deadline_ms=args.deadline_ms)
    if args.artifact:
        return BatchedServer(eval_step=served, buckets=served.buckets, **kw)
    return BatchedServer(served, device=next(served.parameters()).device,
                         buckets=DEFAULT_NODE_BUCKETS, branch_3d_only=not args.full_branch,
                         **kw)


def sweep_summary(curve: Sequence[dict], deadline_p99_ms: float) -> dict:
    """The knee and the deadline-bounded operating point of a load curve
    (rows of ``clients``, ``scenes_per_sec``, ``p99_latency_ms``, sorted by
    clients).  Closed-loop client count is the offered load; the knee is
    the last point whose marginal throughput per added client is still at
    least 25 % of the first point's per-client throughput (past it, added
    load only adds queueing).  The operating point is the fastest point
    whose p99 is within the budget, or None."""
    per1 = curve[0]["scenes_per_sec"] / curve[0]["clients"]
    knee = curve[0]
    for prev, cur in zip(curve, curve[1:]):
        gain = (cur["scenes_per_sec"] - prev["scenes_per_sec"]) / \
            (cur["clients"] - prev["clients"])
        if gain < 0.25 * per1:
            break
        knee = cur
    within = [r for r in curve if r["p99_latency_ms"] <= deadline_p99_ms]
    op = max(within, key=lambda r: r["scenes_per_sec"]) if within else None
    return {"curve": list(curve), "knee": knee, "deadline_p99_ms": deadline_p99_ms,
            "deadline_operating_point": op}


def _sweep(server, scenes, args) -> dict:
    from vlsat_tpu_torch.serving import bench_server

    curve = []
    for c in sorted(set(args.sweep_clients)):
        r = bench_server(server, scenes, duration_s=args.duration, clients=c)
        row = {"clients": c, "scenes_per_sec": round(r["scenes_per_sec"], 1),
               "p50_latency_ms": round(r["p50_latency_ms"], 1),
               "p99_latency_ms": round(r["p99_latency_ms"], 1),
               "mean_batch": round(r["mean_batch_size"], 2)}
        curve.append(row)
        print(json.dumps(row), flush=True)
    return sweep_summary(curve, args.deadline_p99_ms)


def _http(server, scenes, args) -> dict:
    """The closed-loop load through the HTTP transport: npz encode, POST,
    decode on top of the micro-batcher."""
    from vlsat_tpu_torch.serving import HTTPFrontend

    with HTTPFrontend(server, port=0) as fe:
        url = f"http://127.0.0.1:{fe.port}/predict"

        def post(s):
            buf = io.BytesIO()
            np.savez(buf, **s)
            req = urllib.request.Request(url, data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=1800) as resp:
                with np.load(io.BytesIO(resp.read()), allow_pickle=False) as z:
                    return {k: z[k] for k in z.files}

        post(scenes[0])  # warm both buckets
        post(scenes[6])
        lat, errors, lock = [], [], threading.Lock()
        stop_t = time.monotonic() + args.duration

        def client(i):
            rng2 = np.random.RandomState(100 + i)
            local = []
            try:
                while time.monotonic() < stop_t:
                    s = scenes[int(rng2.randint(len(scenes)))]
                    t0 = time.monotonic()
                    post(s)
                    local.append(time.monotonic() - t0)
            except Exception as e:  # a failed request fails the run, not one client
                errors.append(e)
            with lock:
                lat.extend(local)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(args.clients)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} of {args.clients} HTTP clients failed") from errors[0]
    arr = np.asarray(lat) * 1e3
    return {"scenes_per_sec": len(lat) / wall,
            "p50_latency_ms": float(np.percentile(arr, 50)) if len(arr) else None,
            "p99_latency_ms": float(np.percentile(arr, 99)) if len(arr) else None,
            "mean_batch_size": server.stats["batch_size_sum"] / max(server.stats["batches"], 1)}


def _naive(model, scenes, args) -> dict:
    """Per-scene dispatch (what a server without batching does): each scene
    padded to 16 nodes, one eval step at B=1, its logits copied back."""
    from vlsat_tpu_torch.scene import collate, full_edge_index, pad_scene
    from vlsat_tpu_torch.train.step import make_eval_step

    dev = next(model.parameters()).device
    step = make_eval_step(model, branch_3d_only=not args.full_branch, device=dev)
    state = model.state_dict()

    def one(s):
        n = s["obj_points"].shape[0]
        padded = pad_scene(s["obj_points"], s["descriptor"], s["obj_2d_feats"],
                           np.zeros((n,), np.int32), full_edge_index(n),
                           np.zeros((n * (n - 1), 26), np.float32), n_max=16)
        return step(state, collate([padded]))["obj_logits_3d"].cpu().numpy()

    one(scenes[0])  # warm
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < args.duration:
        one(scenes[k % len(scenes)])
        k += 1
    return {"scenes_per_sec": k / (time.perf_counter() - t0)}


def main(argv=None) -> Optional[dict]:
    """Run the tool; returns the result JSON it prints."""
    from vlsat_tpu_torch.serving import bench_server

    args = parse_args(argv)
    served = load_served(args)
    if args.export_artifact:
        from vlsat_tpu_torch.serving_export import export_serving_artifact

        manifest = export_serving_artifact(
            served, args.export_artifact, buckets=ARTIFACT_BUCKETS, max_batch=args.max_batch,
            num_points=128, branch_3d_only=not args.full_branch,
            device=next(served.parameters()).device)
        res = {"exported": args.export_artifact,
               "buckets": sorted(int(b) for b in manifest["buckets"]),
               "outputs": manifest["outputs"]}
        print(json.dumps(res, indent=2))
        return res

    scenes = request_pool()
    server = build_server(args, served)
    with server:
        # warm both buckets the pool can produce (12 and 16) before any timing
        server.predict(scenes[0], timeout=1800)   # 9 nodes  -> bucket 12
        server.predict(scenes[6], timeout=1800)   # 16 nodes -> bucket 16
        if args.sweep:
            res = _sweep(server, scenes, args)
        else:
            res = bench_server(server, scenes, duration_s=args.duration, clients=args.clients)
    out = {"batched": res}
    if args.http:
        out["http"] = _http(build_server(args, served), scenes, args)
    if args.naive and args.artifact:
        print("note: --naive skipped with --artifact (the exported program is compiled for "
              "the padded max_batch shape only)")
        args.naive = False
    if args.naive:
        out["naive_per_scene_dispatch"] = _naive(served, scenes, args)

    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
