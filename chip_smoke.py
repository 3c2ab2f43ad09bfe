"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build the CUDA kernels of ``vlsat_tpu_torch/csrc`` with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch twin on the card at the
   serving path's shapes (node buckets 16, 48 and 64, 32 scenes; the fused
   PointNet also in its point-chunked v2 configuration): segment-max must be
   bit-equal, PointNet within rtol 1e-4 / atol 1e-5 (3xTF32 products on
   the tensor cores against cuBLAS fp32);
3. time each kernel, its twin and the one-call library yardstick with CUDA
   events, and compute each kernel's bound from its shapes: segment-max by
   bytes, PointNet by operations at the 3xTF32 rate (three TF32 products
   per fp32 product at 495 TFLOP/s), with the share of the bound reached;
4. build the full-width MMGNet (768/512/256, 8 heads, depth 2, 160 objects,
   26 predicates, fused PointNet) from a seeded torch.Generator;
5. serve synthetic scenes of 4-40 nodes through ``BatchedServer`` from
   several client threads, with every launch counter set to 0 just before
   and read just after; every future must resolve with finite outputs and
   both kernels must have launched;
6. re-run a few served scenes through the same weights on the CPU and
   compare at the model gate (rtol 1e-3, atol 1e-4);
7. profile one served batch (32 scenes) with torch.profiler: step wall
   time, device busy time and idle share, and the kernels that take it;
8. evaluate: ``eval.engine.evaluate`` with the dual-branch eval step on
   labelled synthetic splits at B=32 (256 scenes with the node and relation
   counts of the 3DSSG validation split, buckets 8/12; 32 scenes at bucket
   48; 32 at bucket 64, which reaches the library attention route), with
   ``scene_recall`` and a triplet vocabulary: finite metrics, segment-max
   launched 4 times and the fused PointNet once per batch (counters at 0
   just before each run), the card's forward equal to a CPU forward at the
   model gate on two batches, its object and predicate ranks bit-equal to
   the same rank functions on the CPU (triplet mismatches printed with the
   margin of the tie that flipped them); scenes/s, wall ms per batch, device
   busy ms, idle share, top kernels and peak memory per bucket;
9. train: ``train.step.make_train_step`` at B=8 with text targets, AdamW at
   lr 1e-4 with the cosine schedule and the DYNAMIC loss: 20 timed steps on
   3DSSG-like batches (buckets 8/12) and 3 at bucket 48 (step wall ms,
   scenes/s, peak memory), torch.profiler over a few more per bucket
   (device busy ms, idle share), 8 steps on one repeated batch whose loss
   must fall, and no segment-max or PointNet launch in any train step (the
   JAX train step runs no Pallas call); one step on the card and on the CPU
   from identical weights with every dropout off, in fp64 and in fp32
   (loss rtol 1e-4; every gradient leaf at the gate of
   tests/test_parity_torch.py, on every element in fp64 and on 99.5 % of
   each leaf's elements in fp32); the eval-mode gradient of the object
   encoder through the fused PointNet kernel equal to the plain route's at
   the fp32 gate;
10. data feed: a 548-scan split with the node and relation counts of the
    3DSSG validation split, written as PLY files (a few thousand vertices
    per instance plus unlabelled clutter), parsed by the native reader in
    ``data.dataset.SSGScenes`` and packed by ``data.packed.pack_scenes``
    with stand-in text targets (pack time, scenes/s, bytes); placed on the
    card by ``data.resident.ResidentScenes`` (bytes, time); evaluated at B=32
    through the streaming ``PackedLoader`` (f16 and bit-exact f32 wire),
    ``ResidentEvalLoader`` and ``ResidentGroupedEval`` (K = 4): resident
    metrics equal to the f32 streaming run's, the grouped run's rank lists
    against them with every mismatch counted (at most 0.1 % of the ranks,
    and the padded tail batches' outputs within rtol 1e-5 of the unpadded
    ones), segment-max launched 4 times and the fused PointNet once per
    evaluated batch or grouped row; wall s, scenes/s, idle share and H2D
    bytes per batch or group; ``make_resident_multi_train_step`` at B=8, K=4
    over ``epoch_permutations`` with the pack's text table, its first
    group's losses within 1e-6 relative of ``make_multi_train_step``'s on
    the same rows (dropout off), trained scenes/s of both, step wall ms and
    idle share; and a sweep of B in {16, 32, 64} over the grouped path at
    buckets 8 and 12 (the port's ``DEFAULT_EVAL_BATCH`` entries);
11. the runner and the CLI, over phase 10's PLY split: a ``TripletTextCache`` of the train split's sentences from
    ``HashTextEncoder``; one experiment JSON at the full MODEL width (B=8,
    2 epochs, validation every epoch, ``EVAL_BATCH_SIZE="auto"``,
    ``TRAIN_MICROSTEPS`` 4, resident train and eval splits, ``EVAL_GROUP``
    4); ``python -m vlsat_tpu_torch.tools.pack_dataset`` in a subprocess;
    ``vlsat_tpu_torch.main.main`` in this process for ``--mode train``
    (every launch counter at 0 just before: segment-max exactly 4 times per
    evaluated batch of the 3 validations, none in a train step, no
    PointNet; 2 epoch rows with the card's peak memory, finite logged
    losses, the latest and best checkpoints and ``result.txt``) and
    ``--mode eval`` (its metrics equal to the train run's closing
    validation, no tolerance; 4 segment-max launches per batch); then
    ``python -m vlsat_tpu_torch.main --mode serve --port 0`` in a
    subprocess: its first 4 answers (one request at a time, before the
    load) held against the CPU's eval step on the checkpoint's weights at
    the model gate, then 8 HTTP client threads for a few seconds (scenes/s,
    p50 / p99 latency), ``/healthz`` counting every request, 400 on a
    payload without ``descriptor``, and exit code 0 within 30 s of SIGINT;
12. the model zoo: ``MmgnetSingle``, ``SGFN``, ``SGPN`` (256-point union
    clouds), ``MMteacher``, ``MmgnetIn21k`` (768-d 2D features),
    ``SGGpoint`` and ``SGGpointBaseline`` (DGCNN backbone, P=128, k=20,
    768 / 512 wide) from ``models.registry.build_model`` at the default
    MODEL widths with seeded weights; each evaluated by
    ``eval.engine.evaluate`` at B=32 over phase 8's 5-9-node split (finite
    metrics; segment-max launched 2, 2, 0, 4, 4, 0 and 0 times per batch,
    counters at 0 just before), its card forward equal to a CPU forward at
    the model gate on two batches with object and predicate ranks
    bit-equal (for the SGGpoint family the (point, stage) kNN neighbour
    sets of card and CPU are counted, more than 1e-3 of them differing
    fails, and the gate holds on every scene whose sets all agree), a
    profiled pass at bucket 12; 10 timed train steps at B=8 with the
    registry's loss and text targets (no kernel launch), a profiled few,
    the loss falling over 8 steps on one batch, and one fp64 step card
    against CPU (loss rtol 1e-4, every gradient leaf at the gate, every
    neighbour set equal); then ``main --mode train`` (1 epoch) and
    ``--mode eval`` for ``NAME=SGFN`` on phase 11's pack and JSON (eval
    metrics equal to the closing validation's, no tolerance; 2 segment-max
    launches per evaluated batch); then a seeded directory of reference
    per-module ``.pth`` files for ``Mmgnet`` imported onto the card by
    ``interop.torch_import`` (dual forward equal to the CPU's at the model
    gate);
13. the deployment artifacts: phase 4's model's 3D-only forward exported
    by ``serving_export.export_serving_artifact`` at B=32, buckets 16 and
    48 (both kernels are ``vlsat::*`` operators inside the programs;
    tracing launches none), reloaded in a subprocess that imports no module
    of ``vlsat_tpu_torch.models`` (outputs within rtol/atol 1e-6 of the
    live eval step's on one batch a bucket of phase 5's scenes, kernel
    launches equal); phase 5's scenes served through ``BatchedServer`` on
    the artifact and on the live model in turns (scenes/s of each);
    ``python -m vlsat_tpu_torch.main --mode trace`` on phase 11's JSON; one
    evaluation under ``utils.profiling.trace`` in a fresh process, whose
    Chrome trace must hold one event of each kernel a counted launch, and
    the same evaluation profiled in this process (its kernel records
    against its launch calls, recorded); the phase's launches are read
    there, and only then is the host time of a kernel call through its
    operator and through its ctypes wrapper taken;
14. data parallelism (``vlsat_tpu_torch.parallel``) on the one card: rank
    processes from ``parallel.spawn_ranks`` as a one-rank NCCL group and as
    two gloo ranks sharing the card, and the same work in this process with
    no group as the reference, at full width (``fused_pointnet=True``):
    train steps at B=8 on 3DSSG-like batches (buckets 8/12) with text
    targets, DYNAMIC weights and dropout on -- one SGD step (loss rtol
    1e-5, every leaf within max(5e-5, 1e-2 x its update)), three AdamW
    steps (losses rtol 1e-5), no kernel launch, equal weights on every
    rank; evaluation at B=32 over phase 8's split, streamed through
    ``shard_eval_batches`` (the ragged tail padded) and resident through
    ``ResidentShardedEval`` (K = 4), its rank lists against the no-group
    run's with every mismatch counted (at most 0.1 %), segment-max
    launched 4 times and the fused PointNet once per batch in every rank
    (each rank counts its own, summed); trained and evaluated scenes/s of
    no group, dp=1 and dp=2, recorded as the collectives' overhead on one
    card, not as scaling; then ``python -m vlsat_tpu_torch.main --mode
    train --data-parallel`` for one epoch on phase 11's pack and JSON with
    two ranks under ``torch.distributed.run`` and ``--mode eval`` (its
    metrics equal to its closing validation's, one checkpoint directory,
    one ``result.txt``, one epoch row and one metric log, its first logged
    losses within 1e-5 relative of a one-process run's).  Phases 10-14's
    work directories are removed at its end;
15. the offline path, on 16 data-feed scans (the node and relation counts
    of the 3DSSG validation split) laid out as ``<root>/data/3RScan/<scan>``,
    with seeded camera rigs around each scan (PIL decodes every texture,
    view and colour frame file; the phase fails without it);
    ``preprocess.depth.visible_instances_per_frame``
    over 60 rendered 224x172 depth maps at stride 8 against the largest
    scan's labelled points (frames/s; ``backproject_depth`` against the CPU
    at the parity gate, ``nearest_instance``'s assignments equal to the
    CPU's except at near ties, counted); ``projection.MultiViewFeatureExtractor``
    over 60 colour frames at 960x540 for every instance (instances/s;
    ``project_points`` pixels at rtol 1e-5 / atol 1e-4, visibility and crop
    boxes equal away from a border or an integer, the exclusions counted,
    the saved features equal to the CPU's); the OBJ colour transfer
    (``uv_to_color`` on a texture array; ``load_rgb`` where PIL is
    installed); ``clipsem.adapter_train.train_adapter`` at the real job's
    shape (512-d features, the 160-class table, B=32, 4,745 validation and
    35,603 train instances; 4 of the default 20 epochs, to keep the script
    well inside its time limit (12 took 34.0 s on the card and 41.5 s on
    the CPU); steps/s; the first 50 losses
    equal to a CPU run's from the same weights at rtol 1e-4, the best top-1
    within 0.5 points); ``python -m vlsat_tpu_torch.tools.run_full_pipeline``
    in a subprocess (project, text, train, eval; the full-width registry
    ``Mmgnet``, 1 epoch at B=8; frames decoded from PNG files): each
    stage's wall and launches, segment-max launched in the train and eval
    stages, the eval stage's metrics equal to the same stage on the CPU
    from its checkpoint, no tolerance; then ``tools.align_scans`` and
    ``tools.zero_shot_analysis`` on its outputs;
16. the serving and operations tools: ``vlsat_tpu_torch.tools.serve``'s
    ``main`` in this process at full width (``MMGNetConfig()``, fused
    PointNet off as in the JAX tool) with ``--max-batch 32 --clients 64
    --duration 4 --http --naive`` (batched, HTTP and naive scenes/s, p50 /
    p99; segment-max launched, PointNet not, counters at 0 just before),
    four pool scenes answered by the tool's server held against a CPU
    server on the same weights at the model gate, ``--export-artifact``
    then ``--artifact`` (scenes/s from the artifact), and ``--sweep
    --sweep-clients 1 4 16 64 --duration 2`` (curve, knee, operating
    point); ``tools.parity_eval`` on a seeded full-width reference ``.pth``
    directory and a labelled PLY split of its own: once with ``--device
    cpu``, whose metrics become a ``result.txt`` in the reference's
    format, then on the card against it (exit 0, verdict YES, segment-max
    launched 4 times an evaluated batch, the largest card-against-CPU
    metric difference); ``tools.soak`` in a subprocess with ``--num-scans
    1177 --epochs 4 --kill-epoch 3 --valid-interval 2 --batch-size 8``
    (cut from the JAX defaults of 20 epochs, a kill at 12 and validation
    every 5): the child SIGKILLed in epoch 3, phase B at rc 0, resumed
    within one epoch of the kill, the fourth epoch last, every validation
    metric finite; dataset build, phase walls, train scenes/s, peak RSS
    and card memory (the training child's launches are its own process's
    and are not counted here).

The last lines are a ``variants`` line (per model: evaluated
scenes/s, wall ms per batch, trained scenes/s, step wall ms, peak memory,
segment-max launches), an ``export`` line (export seconds a bucket, load
seconds, artifact and ``.pt2`` bytes, scenes/s of both servers, dispatch
microseconds), a ``data_parallel`` line (phase 14's checks, throughput
and CLI run), an ``offline`` line (phase 15's rates, exclusions and stage
walls), a ``tools`` line (phase 16's rates, checks and cuts), a
``phase_wall_s`` line, a JSON ``kernels`` line (with each kernel's
launches in every phase), the card's name and power limit as nvidia-smi reports them,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12        # H100 SXM TF32 tensor cores, dense (data sheet)
SEED = 0
BATCH = 32
BUCKETS = (16, 48, 64)     # node buckets of the kernel phases; serving lands in 48
TRAIN_BATCH = 8            # the JAX config's Batch_Size
EVAL_GROUP = 4             # the JAX config's EVAL_GROUP
TRAIN_GROUP = 4            # train steps per resident multi-step call
FEED_SCANS = 548           # scan-splits of the 3DSSG validation split
VERTS_PER_INST = 3000      # vertices of each annotated instance's mesh
BG_VERTS = 20000           # unlabelled vertices of each scan
WORK = Path(__file__).resolve().parent / ".chip_work" / "data_feed"
RUN_WORK = WORK.parent / "runner"
RUNNER_EPOCHS = 2          # epochs of the runner phase
RUNNER_CLIENTS = 8         # HTTP client threads of the runner phase
RUNNER_HTTP_S = 4.0        # seconds of HTTP load
PAYLOAD = ("obj_points", "descriptor", "obj_2d_feats")  # what a /predict client sends


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def device_kernels(prof) -> list:
    """The key averages of the work the card ran: CUDA events, without the
    user annotations (``Optimizer.step#AdamW.step`` spans the GPU timeline
    of the kernels it issues, which are counted themselves)."""
    ranges = {e.key for e in prof.events() if getattr(e, "is_user_annotation", False)}
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the card, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def edge_inputs(rng, n_nodes, dev, full: bool):
    """B scenes in a bucket of n_nodes: all full (timing) or of random size
    (empty segments and padded edges)."""
    from vlsat_tpu_torch.scene import full_edge_index

    e = n_nodes * (n_nodes - 1)
    ei = np.zeros((BATCH, e, 2), np.int32)
    em = np.zeros((BATCH, e), bool)
    for b in range(BATCH):
        idx = full_edge_index(n_nodes if full else rng.randint(2, n_nodes + 1))
        ei[b, :len(idx)] = idx
        em[b, :len(idx)] = True
    data = rng.randn(BATCH, e, 256).astype(np.float32)
    return (torch.from_numpy(data).to(dev), torch.from_numpy(ei).to(dev),
            torch.from_numpy(em).to(dev))


def check_segment_max(dev, rng) -> list:
    from vlsat_tpu_torch.ops.kernels import segment_max as K

    rows = []
    for n in BUCKETS:
        for full in (False, True):
            data, ei, em = edge_inputs(rng, n, dev, full)
            for target in (0, 1):
                got = K.segment_max_cuda(data, ei, em, n, target)
                want = K.segment_max_plain(data, ei, em, n, target)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"segment_max differs from its twin at bucket {n} "
                         f"(full={full}, target={target}): max abs "
                         f"{(got - want).abs().max().item()}")
        # timing on full scenes (every edge valid), target 0 as on the path
        err = (K.segment_max_cuda(data, ei, em, n) - K.segment_max_plain(data, ei, em, n)
               ).abs().max().item()
        seg = torch.where(em, ei[..., 0].long(), n)[..., None].expand(-1, -1, data.shape[-1])
        zeros = torch.zeros(BATCH, n + 1, data.shape[-1], device=dev)
        valid = int(em.sum())
        nbytes = (valid * data.shape[-1] * 4 + ei.numel() * 4 + em.numel()
                  + BATCH * n * data.shape[-1] * 4)
        ops = valid * data.shape[-1]
        ms = cuda_ms(lambda: K.segment_max_cuda(data, ei, em, n))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3
        row = {
            "name": "segment_max", "route": "cuda",
            "source": "vlsat_tpu_torch/csrc/segment_max.cu",
            "replaces": "vlsat_tpu/ops/pallas/segment_max.py:95",
            "shape": f"B={BATCH} N={n} E={n * (n - 1)} D={data.shape[-1]} "
                     f"cluster={K.cluster_size(BATCH, data.shape[-1])}",
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": cuda_ms(lambda: K.segment_max_plain(data, ei, em, n)),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_FLOPS else "operations",
            "bound_rate": "HBM3 at 3.35 TB/s",
            "share_of_bound": bound_ms / ms,
            "library_ms": cuda_ms(lambda: zeros.scatter_reduce(
                1, seg, data, reduce="amax", include_self=False)),
        }
        log(f"segment_max bucket {n}: bit-equal to its twin; " + json.dumps(row))
        rows.append(row)
    return rows


def check_pointnet(dev, rng) -> list:
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    dims = (3, 64, 128, 768)
    # weights as nn.Linear holds them, (out, in), passed as (in, out) views
    # the way the model passes them
    ws = [torch.from_numpy((rng.randn(b, a) / np.sqrt(a)).astype(np.float32)).to(dev).t()
          for a, b in zip(dims, dims[1:])]
    bs = [torch.from_numpy((rng.randn(b) * 0.1).astype(np.float32)).to(dev) for b in dims[1:]]
    rows = []
    for n in BUCKETS:
        pts = torch.from_numpy((rng.randn(BATCH, n, 128, 3) * 0.5).astype(np.float32)).to(dev)
        want = K.pointnet_encode_plain(pts, ws, bs)
        plain_ms = cuda_ms(lambda: K.pointnet_encode_plain(pts, ws, bs))
        for name, fn in (("pointnet_fused", lambda: K.pointnet_encode_fused(pts, ws, bs)),
                         ("pointnet_fused_v2",
                          lambda: K.pointnet_encode_fused_v2(pts, ws, bs, p_chunk=16))):
            got = fn()
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
                fail(f"{name} differs from its twin at bucket {n}: max abs "
                     f"{(got - want).abs().max().item()}")
            m = BATCH * n
            flops = 2 * m * 128 * sum(a * b for a, b in zip(dims, dims[1:]))
            nbytes = (pts.numel() + sum(w.numel() for w in ws) + sum(b.numel() for b in bs)
                      + m * dims[-1]) * 4
            ms = cuda_ms(fn)
            bound_ms = max(nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3
            row = {
                "name": name, "route": "cuda", "source": "vlsat_tpu_torch/csrc/pointnet.cu",
                "replaces": ("vlsat_tpu/ops/pallas/pointnet_kernel.py:99"
                             if name == "pointnet_fused"
                             else "vlsat_tpu/ops/pallas/pointnet_kernel.py:150"),
                "shape": f"B={BATCH} N={n} P=128 C=3 widths=64,128,768"
                         + (" p_chunk=16" if name.endswith("v2") else ""),
                "max_abs_err": (got - want).abs().max().item(),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= 3 * flops / TF32_FLOPS
                             else "operations"),
                "bound_rate": "3xTF32: 3 TF32 products per fp32 product at 495 TFLOP/s",
                "share_of_bound": bound_ms / ms,
                "library_ms": None,
            }
            log(f"{name} bucket {n}: within rtol 1e-4/atol 1e-5 of its twin; "
                + json.dumps(row))
            rows.append(row)
    return rows


def make_scene(rng, n: int, num_points: int = 128) -> dict:
    """A synthetic scene: n instances of clustered points, descriptor from
    the raw points, points zero-meaned per instance."""
    from vlsat_tpu_torch.ops.descriptor import gen_descriptor

    centers = rng.randn(n, 1, 3).astype(np.float32) * 2.0
    scales = 0.2 + rng.rand(n, 1, 3).astype(np.float32)
    pts = centers + rng.randn(n, num_points, 3).astype(np.float32) * scales
    desc = gen_descriptor(torch.from_numpy(pts)).numpy()
    return {"obj_points": pts - pts.mean(axis=1, keepdims=True), "descriptor": desc}


def serve(model, dev, scenes, clients: int = 4):
    """Every scene once, from ``clients`` threads; then a closed-loop load
    run for throughput and latency."""
    from vlsat_tpu_torch.serving import BatchedServer, bench_server

    results = [None] * len(scenes)
    errors = []

    def client(i):
        try:
            futs = [(k, server.submit(scenes[k])) for k in range(i, len(scenes), clients)]
            for k, fut in futs:
                results[k] = fut.result(timeout=300)
        except Exception as e:  # reported below, fails the run
            errors.append(e)

    with BatchedServer(model, device=dev, max_batch=BATCH, deadline_ms=5.0) as server:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"serving clients failed: {errors!r}")
        bench = bench_server(server, scenes, duration_s=8.0, clients=2 * BATCH)
        torch.cuda.synchronize()
    return results, bench


def profile_forward(model, dev, scenes, reps: int = 5) -> dict:
    """Where one served batch's time goes: the eval step on the first
    BATCH scenes (padded to their bucket), under torch.profiler."""
    from vlsat_tpu_torch.data.wire import encode_wire
    from vlsat_tpu_torch.scene import collate, full_edge_index, pad_scene, pick_bucket
    from vlsat_tpu_torch.train.step import make_eval_step

    group = scenes[:BATCH]
    bucket = pick_bucket(max(s["obj_points"].shape[0] for s in group))
    padded = []
    for s in group:
        n = s["obj_points"].shape[0]
        ei = full_edge_index(n)
        padded.append(pad_scene(s["obj_points"], s["descriptor"],
                                np.zeros((n, 512), np.float32), np.zeros(n, np.int32),
                                ei, np.zeros((len(ei), 26), np.float32), n_max=bucket))
    batch = encode_wire(collate(padded))
    step = make_eval_step(model, branch_3d_only=True, device=dev)
    state = model.state_dict()
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(reps):
            step(state, batch)
            torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / reps
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "bucket": bucket, "scenes": len(group), "step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3 / reps,
                         "calls": e.count / reps} for e in top],
    }


def union_points(rng, sc: dict, num_points: int) -> np.ndarray:
    """SGPN's per-edge union clouds for a synthetic scene, as the dataset
    builds them (``data/dataset.py`` ``_union_points``): ``num_points``
    points drawn from the two endpoints' points, centred, with a membership
    channel (1 subject, 2 object)."""
    world = sc["obj_points"] + sc["descriptor"][:, None, :3]
    p = world.shape[1]
    out = np.zeros((len(sc["edge_index"]), num_points, 4), np.float32)
    for k, (i, j) in enumerate(sc["edge_index"]):
        pick = rng.randint(0, 2 * p, num_points)
        pts = np.concatenate([world[i], world[j]])[pick]
        out[k, :, :3] = pts - pts.mean(0, keepdims=True)
        out[k, :, 3] = 1 + (pick >= p)
    return out


LARGE = (("b48", 33, 48, BATCH), ("b64", 49, 64, BATCH))  # the evaluation phase's


def labelled_splits(seed: int, batch: int = BATCH, large=LARGE, with_text: bool = False,
                    feat_dim: int = 512, num_points_union: int = 0) -> dict:
    """Host batches of ``batch`` scenes: "val" has the node and relation
    counts of 256 draws from the 3DSSG validation split (5-9 nodes), grouped
    by node bucket; each (name, lo, hi, count) of ``large`` holds ``count``
    scenes of lo-hi nodes.  ``with_text`` adds unit-norm per-edge text
    targets (the rel-mimic loss's); ``feat_dim`` is the width of the 2D
    features; ``num_points_union`` > 0 adds SGPN's union clouds of that many
    points (from a stream of their own, so the rest of a split does not
    change)."""
    from vlsat_tpu_torch.scene import collate, pad_scene, pick_bucket

    splits = {}
    for name, scenes in split_scenes(seed, large, with_text, feat_dim,
                                     num_points_union).items():
        by_bucket: dict = {}
        for sc in scenes:
            by_bucket.setdefault(pick_bucket(sc["obj_points"].shape[0]), []).append(sc)
        batches = []
        for bucket in sorted(by_bucket):
            group = by_bucket[bucket]
            for lo in range(0, len(group), batch):
                batches.append(collate([pad_scene(
                    sc["obj_points"], sc["descriptor"], sc["obj_2d_feats"], sc["gt_class"],
                    sc["edge_index"], sc["gt_rels"], n_max=bucket,
                    rel_text_feat=sc.get("rel_text_feat"), rel_points=sc.get("rel_points"))
                    for sc in group[lo:lo + batch]], with_text=with_text))
        splits[name] = batches
    return splits


def split_scenes(seed: int, large=LARGE, with_text: bool = False, feat_dim: int = 512,
                 num_points_union: int = 0) -> dict:
    """The scenes of ``labelled_splits`` (same arguments), unpadded."""
    from vlsat_tpu_torch.data.synthetic import (edge_text_targets, make_scene,
                                                validation_scene_stats)
    from vlsat_tpu_torch.scene import edge_count

    rng = np.random.RandomState(seed)
    urng = np.random.RandomState(seed + 1000)
    nodes, rels = validation_scene_stats(256, seed=seed)
    specs = {"val": list(zip(nodes, rels))}
    for name, lo, hi, count in large:
        specs[name] = [(int(n), None) for n in rng.randint(lo, hi + 1, count)]
    splits = {}
    for name, spec in specs.items():
        scenes = []
        for n, r in spec:
            # the split's own label density where it has one
            density = 0.08 if r is None else min(1.0, r / (edge_count(n) * 26))
            sc = make_scene(rng, n, rel_density=density, feat_dim=feat_dim)
            if with_text:
                sc["rel_text_feat"] = edge_text_targets(rng, len(sc["edge_index"]))
            if num_points_union:
                sc["rel_points"] = union_points(urng, sc, num_points_union)
            scenes.append(sc)
        splits[name] = scenes
    return splits


def triplet_vocab(batches: list, cap: int = 4096) -> set:
    """A training vocabulary for a split: the GT triplets of every other
    scene, up to ``cap`` of them (the engine parses it on every call), so
    that both zero-shot and non-zero-shot recall are defined."""
    vocab: set = set()
    for b in batches:
        for k in range(0, b.num_scenes, 2):
            em = b.edge_mask[k].numpy()
            ei = b.edge_index[k].numpy()[em]
            cls = b.gt_class[k].numpy()
            for e, p in zip(*np.nonzero(b.gt_rels[k].numpy()[em] > 0)):
                if len(vocab) >= cap:
                    return vocab
                vocab.add(f"{cls[ei[e, 0]]} {cls[ei[e, 1]]} {p}")
    return vocab


def triplet_margin(out: dict, batch, tag: str, b: int, e: int, k: int) -> float:
    """How near a tie the rank of GT predicate k on edge e of scene b sits:
    the least relative gap between the GT cube cell and any other cell
    (CPU, f32, from the card's outputs)."""
    probs = torch.softmax(out[f"obj_logits_{tag}"][b].float(), -1)
    i, j = batch.edge_index[b, e].long().tolist()
    s, o, r = probs[i], probs[j], out[f"rel_cls_{tag}"][b, e].float()
    cube = (s[:, None] * o[None, :])[..., None] * r
    gi, gj = batch.gt_class[b, i].item(), batch.gt_class[b, j].item()
    thr = (s[gi] * o[gj]) * r[k]
    gap = ((cube - thr).abs() / thr).flatten()
    gap[(gi * s.numel() + gj) * r.numel() + k] = float("inf")
    return gap.min().item()


@contextlib.contextmanager
def knn_sets():
    """Records the neighbour indices of every kNN that ``ops.dgcnn`` computes
    in the block (the SGGpoint family's four EdgeConv stages a forward),
    each (B, N, P, k) sorted along k, on the CPU."""
    from vlsat_tpu_torch.ops import dgcnn

    real, calls = dgcnn.knn_indices, []

    def record(x, k):
        idx = real(x, k)
        calls.append(idx.sort(dim=-1).values.cpu())
        return idx

    dgcnn.knn_indices = record
    try:
        yield calls
    finally:
        dgcnn.knn_indices = real


def knn_mismatches(got: list, want: list, obj_mask) -> torch.Tensor:
    """(B, N, P) count of stages whose neighbour set differs between two
    recorded forwards, on valid nodes (a padded node's all-zero cloud ties
    every distance, so which of its points is kept does not matter)."""
    if len(got) != len(want):
        fail(f"kNN stages recorded: {len(got)} against {len(want)}")
    diff = sum((g != w).any(-1).int() for g, w in zip(got, want))
    return diff * obj_mask[..., None].int()


def check_eval_batch(model, state, dev, batch, knn: bool = False) -> dict:
    """One batch of the 5-9-node split: the card's forward against a CPU
    forward of the same weights (model gate), and the card's ranks against
    the CPU rank functions on the card's own outputs.

    ``knn`` (the SGGpoint family): card and CPU round the kNN distances
    differently, so near-tied neighbours can flip.  Every (point, stage)
    neighbour set is compared; more than 1e-3 of the valid point rows
    differing fails; the outputs are held at the gate on every scene whose
    sets all agree (attention and the GCN mix a scene's nodes, so one
    flipped set moves all of its scene's outputs), and fewer than 3/4 of the
    batch's scenes so held fails."""
    from vlsat_tpu_torch.data.wire import encode_wire
    from vlsat_tpu_torch.eval import metrics as M
    from vlsat_tpu_torch.train.step import make_eval_step

    wire = encode_wire(batch)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    with knn_sets() as card_sets:
        card = make_eval_step(model, device=dev)(state, wire)
    with knn_sets() as cpu_sets:
        ref = make_eval_step(model, device="cpu")(cpu_state, wire)
    masks = {"obj": batch.obj_mask, "rel": batch.edge_mask}
    knn_report = {}
    if knn:
        diff = knn_mismatches(card_sets, cpu_sets, batch.obj_mask)
        rows = int(batch.obj_mask.sum()) * batch.obj_points.shape[2] * len(card_sets)
        flipped = int(diff.sum())
        agree = (diff.flatten(1).sum(1) == 0)
        knn_report = {"knn_stages": len(card_sets), "knn_point_rows": rows,
                      "knn_set_mismatches": flipped,
                      "scenes_gated": int(agree.sum()), "scenes": int(agree.numel())}
        if flipped > 1e-3 * rows:
            fail(f"eval forward: {flipped} of {rows} (point, stage) neighbour sets differ "
                 "between the card and the CPU (more than 1e-3)")
        if 4 * int(agree.sum()) < 3 * agree.numel():
            fail(f"eval forward: only {int(agree.sum())} of {agree.numel()} scenes have every "
                 "neighbour set equal on the card and the CPU (fewer than 3/4)")
        masks = {k: m & agree[:, None] for k, m in masks.items()}
    for key in ("obj_logits_3d", "obj_logits_2d", "rel_cls_3d", "rel_cls_2d"):
        got, want = card[key].cpu(), ref[key]
        m = masks[key.split("_")[0]]
        if not torch.allclose(got[m], want[m], rtol=1e-3, atol=1e-4):
            fail(f"eval forward {key} differs from the CPU run: max abs "
                 f"{(got[m] - want[m]).abs().max().item()}")
    host = {k: v.cpu() for k, v in card.items()}
    gdev = batch.to(dev)
    mism = []
    for tag in ("3d", "2d"):
        ol, rc = card[f"obj_logits_{tag}"], card[f"rel_cls_{tag}"]
        if not torch.equal(M.object_ranks(ol, gdev.gt_class).cpu(),
                           M.object_ranks(host[f"obj_logits_{tag}"], batch.gt_class)):
            fail(f"object ranks ({tag}) on the card differ from the CPU's")
        for g, w in zip(M.predicate_rank_parts(rc), M.predicate_rank_parts(host[f"rel_cls_{tag}"])):
            if not torch.equal(g.cpu(), w):
                fail(f"predicate ranks ({tag}) on the card differ from the CPU's")
        tg = M.triplet_rank_parts(ol, gdev.gt_class, rc, gdev.edge_index)[0].cpu()
        tw = M.triplet_rank_parts(host[f"obj_logits_{tag}"], batch.gt_class,
                                  host[f"rel_cls_{tag}"], batch.edge_index)[0]
        live = batch.edge_mask[..., None] & (batch.gt_rels > 0)
        for b, e, k in torch.nonzero((tg != tw) & live).tolist():
            mism.append({"branch": tag, "scene": b, "edge": e, "predicate": k,
                         "card_rank": tg[b, e, k].item(), "cpu_rank": tw[b, e, k].item(),
                         "margin": triplet_margin(host, batch, tag, b, e, k)})
    if knn:
        knn_report["gated_max_abs_diff"] = {
            k: (card[k].cpu() - ref[k])[masks[k.split("_")[0]]].abs().max().item()
            for k in ("obj_logits_3d", "obj_logits_2d", "rel_cls_3d", "rel_cls_2d")}
    return {"max_abs_diff": {k: (card[k].cpu() - ref[k]).abs().max().item() for k in ref},
            **knn_report,
            "triplet_mismatches": len(mism), "triplet_mismatch_examples": mism[:10],
            "triplet_ranks_checked": int((batch.edge_mask[..., None] & (batch.gt_rels > 0)
                                          ).sum()) * 2}


def profile_eval(step, state, batches) -> dict:
    """evaluate() over ``batches`` of one bucket under torch.profiler, after
    a warm-up run: wall and device busy ms per batch, idle share, the top
    kernels, the attention kernels and the peak memory."""
    from vlsat_tpu_torch.eval.engine import evaluate

    evaluate(step, state, batches, verbose=False, scene_recall=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        evaluate(step, state, batches, verbose=False, scene_recall=True)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = prof.key_averages()
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    attn = [e.key[:90] for e in top
            if any(w in e.key.lower() for w in ("fmha", "attention", "flash", "softmax"))]
    nb = len(batches)
    return {"bucket": batches[0].num_nodes, "batches": nb,
            "scenes": sum(b.num_scenes for b in batches),
            "wall_ms_per_batch": wall_ms / nb, "device_busy_ms_per_batch": busy_ms / nb,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernels_per_batch": sum(e.count for e in kernels) / nb,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "top_kernels": [{"name": e.key[:90], "ms_per_batch": e.self_device_time_total / 1e3 / nb,
                             "calls_per_batch": e.count / nb} for e in top[:8]],
            "top_host_ops": [{"name": e.key[:60], "self_ms_per_batch":
                              e.self_cpu_time_total / 1e3 / nb, "calls_per_batch": e.count / nb}
                             for e in host[:8]],
            "attention_kernels": attn[:6]}


def evaluation(model, dev, cfg) -> dict:
    """Phase 8: the evaluation path on the card."""
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.step import make_eval_step

    t0 = time.monotonic()
    splits = labelled_splits(SEED + 2)
    vocabs = {k: triplet_vocab(v) for k, v in splits.items()}
    log(f"evaluation: splits built in {time.monotonic() - t0:.1f} s: "
        + ", ".join(f"{k} {sum(b.num_scenes for b in v)} scenes in {len(v)} batches "
                    f"(buckets {sorted({b.num_nodes for b in v})}, vocabulary of "
                    f"{len(vocabs[k])} triplets)" for k, v in splits.items()))
    step = make_eval_step(model, device=dev)
    state = model.state_dict()
    kw = dict(num_rel_classes=cfg.num_rel_classes, verbose=False, scene_recall=True)
    for k, batches in splits.items():  # warm-up: first-call allocations and GEMM choices
        evaluate(step, state, batches, train_triplet_vocab=vocabs[k], **kw)
    torch.cuda.synchronize()
    runs, launches = {}, {"segment_max": 0, "pointnet_fused": 0}
    # the 5-9-node split twice, for the spread of scenes/s; launches_eval
    # counts the first pass over each split
    for name, split in [("val", "val"), ("val_repeat", "val"), ("b48", "b48"), ("b64", "b64")]:
        batches = splits[split]
        segment_max.launches = 0
        pointnet_kernel.launches = 0
        pointnet_kernel.launches_v2 = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        metrics = evaluate(step, state, batches, train_triplet_vocab=vocabs[split], **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        seg, pn = segment_max.launches, pointnet_kernel.launches
        nb = len(batches)
        if seg != 4 * nb or pn != nb or pointnet_kernel.launches_v2:
            fail(f"evaluation of {name}: {seg} segment-max and {pn} fused PointNet launches "
                 f"for {nb} batches (want {4 * nb} and {nb})")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad or len(metrics) < 56:
            fail(f"evaluation of {name}: {len(metrics)} metrics, non-finite: {bad}")
        if name != "val_repeat":
            launches["segment_max"] += seg
            launches["pointnet_fused"] += pn
        scenes = sum(b.num_scenes for b in batches)
        runs[name] = {"scenes": scenes, "batches": nb, "wall_s": wall,
                      "scenes_per_sec": scenes / wall, "wall_ms_per_batch": wall * 1e3 / nb,
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": {"segment_max": seg, "pointnet_fused": pn},
                      "metrics": metrics}
        log(f"evaluation of {name}: {scenes} scenes in {wall:.2f} s ({scenes / wall:.1f} "
            f"scenes/s), {len(metrics)} finite metrics; launches segment-max {seg}, "
            f"fused PointNet {pn} for {nb} batches")

    checks = [check_eval_batch(model, state, dev, b) for b in splits["val"][:2]]
    for c in checks:
        log("evaluation check, card against CPU on one batch of the 5-9-node split: "
            + json.dumps(c))
    log("evaluation: card forward within rtol 1e-3/atol 1e-4 of the CPU forward on 2 "
        "batches; object and predicate ranks bit-equal to the CPU's on the card's outputs")
    val = splits["val"]
    groups = [[b for b in val if b.num_nodes == n] for n in sorted({b.num_nodes for b in val})]
    profiles = [profile_eval(step, state, g) for g in groups + [splits["b48"], splits["b64"]]]
    return {"runs": runs, "launches": launches, "checks": checks, "profiles": profiles}


def dropout_off(model):
    from vlsat_tpu_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def grad_gate(got: dict, want: dict, what: str, min_frac: float = 1.0) -> dict:
    """Each gradient leaf at the gate of tests/test_parity_torch.py:568-575:
    isclose(rtol 2e-3, atol 2e-3 * max|g| of the leaf, floored at 1e-6 of
    the largest gradient, since a key bias's gradient is zero up to
    rounding) on at least ``min_frac`` of its elements.  Fails the run
    otherwise; returns the worst leaves."""
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    rows = []
    for n, w in want.items():
        g = got[n]
        scale = max(w.abs().max().item(), floor)
        ok = torch.isclose(g, w, rtol=2e-3, atol=2e-3 * scale)
        rows.append({"leaf": n, "inside": ok.double().mean().item(), "outside": int((~ok).sum()),
                     "max_abs_diff": (g - w).abs().max().item(), "max_abs_grad": scale})
    rows.sort(key=lambda r: (r["inside"], -r["max_abs_diff"] / r["max_abs_grad"]))
    if sorted(got) != sorted(want):
        fail(f"{what}: gradient leaves {sorted(set(got) ^ set(want))} on one side only")
    if rows[0]["inside"] < min_frac:
        fail(f"{what}: gradient leaves outside the gate on more than {1 - min_frac:.1%} "
             f"of their elements: {[r for r in rows if r['inside'] < min_frac]}")
    return {"leaves": len(rows), "min_frac": min_frac,
            "leaves_with_elements_outside": sum(r["outside"] > 0 for r in rows),
            "elements_outside": sum(r["outside"] for r in rows), "worst": rows[:4]}


def as_dtype(batch, dtype):
    return batch.replace(**{f: getattr(batch, f).to(dtype) for f in
                            ("obj_points", "descriptor", "obj_2d_feats", "gt_rels",
                             "rel_text_feat", "rel_points") if getattr(batch, f) is not None})


def grads_of(model, prefix: str = "") -> dict:
    return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
            if p.grad is not None and n.startswith(prefix)}


def profile_train(step, state, batches) -> dict:
    """Train steps over ``batches`` (one bucket): wall ms per step of a run
    without the profiler, then the same steps under torch.profiler for the
    device busy ms and the kernels; the idle share is 1 - busy / the
    unprofiled wall (the profiler slows the host ~2x on small steps)."""
    walls = []
    for profiled in (False, True):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext() \
                as prof:
            t0 = time.monotonic()
            for i, b in enumerate(batches):
                step(state, b, 100 + i)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    n = len(batches)
    return {"bucket": batches[0].num_nodes, "steps": n, "scenes_per_step": batches[0].num_scenes,
            "step_wall_ms": walls[0] / n, "profiled_step_wall_ms": walls[1] / n,
            "device_busy_ms": busy_ms / n, "device_idle_share": 1 - busy_ms / walls[0],
            "kernels_per_step": sum(e.count for e in kernels) / n,
            "top_kernels": [{"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / n,
                             "calls_per_step": e.count / n} for e in top]}


def training(dev) -> dict:
    """Phase 9: the training step on the card (full width, B=8, AdamW at
    lr 1e-4 with the cosine schedule, the DYNAMIC loss with both mimic
    terms)."""
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.losses import vlsat_total_loss
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_train_step

    cfg = MMGNetConfig(fused_pointnet=True)
    t0 = time.monotonic()
    splits = labelled_splits(SEED + 3, batch=TRAIN_BATCH,
                             large=(("b48", 33, 48, 3 * TRAIN_BATCH),), with_text=True)
    val, b48 = splits["val"], splits["b48"]
    log(f"training: {len(val)} batches of the 5-9-node split (buckets "
        f"{sorted({b.num_nodes for b in val})}) and {len(b48)} at bucket 48, B={TRAIN_BATCH}, "
        f"built in {time.monotonic() - t0:.1f} s")
    spec = make_optimizer(lr=1e-4, max_iteration=1000)
    model = build_mmgnet(cfg, device=dev, seed=SEED + 3)
    state = create_train_state(model, spec)
    step = make_train_step(model, spec, device=dev)
    for b in {b.num_nodes: b for b in val + b48}.values():  # warm-up, one step per shape
        step(state, b, 0)
    torch.cuda.synchronize()

    segment_max.launches = 0
    pointnet_kernel.launches = 0
    pointnet_kernel.launches_v2 = 0
    runs = {}
    for name, batches in (("val", val[:20]), ("b48", b48[:3])):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        losses = []
        for i, b in enumerate(batches):
            _, aux = step(state, b, i)
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        losses = torch.stack(losses).cpu()
        if not torch.isfinite(losses).all():
            fail(f"training on {name}: non-finite losses {losses.tolist()}")
        scenes = sum(b.num_scenes for b in batches)
        runs[name] = {"steps": len(batches), "scenes": scenes,
                      "buckets": sorted({b.num_nodes for b in batches}),
                      "step_wall_ms": wall * 1e3 / len(batches), "scenes_per_sec": scenes / wall,
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "losses": losses.tolist()}
        log(f"training on {name}: {len(batches)} steps, {scenes} scenes in {wall:.2f} s "
            f"({scenes / wall:.1f} scenes/s), peak {runs[name]['peak_memory_gib']:.2f} GiB")
    groups = [[b for b in val[20:] if b.num_nodes == n] for n in sorted({b.num_nodes for b in val})]
    profiles = [profile_train(step, state, g[:6]) for g in groups if g]
    profiles.append(profile_train(step, state, b48[:3]))

    # the loss falls on a repeated fixed batch (tests/test_train_step.py:19-33)
    fixed = build_mmgnet(cfg, device=dev, seed=SEED + 4)
    fixed_state = create_train_state(fixed, spec)
    fixed_step = make_train_step(fixed, spec, device=dev)
    fixed_losses = [fixed_step(fixed_state, val[0], 0)[1]["loss"] for _ in range(8)]
    fixed_losses = torch.stack(fixed_losses).cpu().tolist()
    if not fixed_losses[-1] < fixed_losses[0]:
        fail(f"training: the loss did not fall over 8 steps on one batch: {fixed_losses}")
    launches = {"segment_max": segment_max.launches, "pointnet_fused": pointnet_kernel.launches,
                "pointnet_fused_v2": pointnet_kernel.launches_v2}
    if any(launches.values()):
        fail(f"training launched kernels {launches}; the JAX train step runs no Pallas call")
    log(f"training: loss on one repeated batch {fixed_losses[0]:.4f} -> {fixed_losses[-1]:.4f} "
        f"in 8 steps; kernel launches in all train steps {launches}")

    # one step on the card and on the CPU from identical weights, dropout off:
    # in fp64 every element must pass (rounding cannot flip a max there); in
    # fp32, the path's precision, a near-tie in a max aggregation or a ReLU
    # decided by rounding moves a few elements (a 1e-7 relative perturbation
    # of the weights moves the same leaves as much on the CPU), so each leaf
    # must pass on 99.5 % of its elements, the least fraction that
    # tests/test_parity_torch.py grants a leaf
    batch = next(b for b in val if b.num_nodes == 12)
    card_vs_cpu = {}
    for dtype, min_frac in ((torch.float64, 1.0), (torch.float32, 0.995)):
        pair = [dropout_off(build_mmgnet(cfg, device=d, seed=SEED + 5)).to(dtype)
                for d in (dev, "cpu")]
        step_losses = []
        for m, d in zip(pair, (dev, "cpu")):
            st = create_train_state(m, spec)
            _, aux = make_train_step(m, spec, device=d)(st, as_dtype(batch, dtype), 0)
            step_losses.append(aux["loss"].item())
        tag = str(dtype).split(".")[-1]
        if not np.isclose(step_losses[0], step_losses[1], rtol=1e-4, atol=0):
            fail(f"{tag} train step loss on the card {step_losses[0]} != CPU {step_losses[1]} "
                 "(rtol 1e-4)")
        gate = grad_gate(grads_of(pair[0]), grads_of(pair[1]),
                         f"{tag} train step, card against CPU", min_frac)
        card_vs_cpu[tag] = {"loss": step_losses, "gradients": gate}
        log(f"training: one {tag} step card against CPU (bucket 12, B={batch.num_scenes}, "
            f"dropout off): loss {step_losses[0]:.9g} / {step_losses[1]:.9g}; "
            f"{gate['leaves']} gradient leaves at the gate on >= {min_frac:.1%} of their "
            f"elements, {gate['elements_outside']} elements outside in "
            f"{gate['leaves_with_elements_outside']} leaves")

    # eval-mode gradient through the fused PointNet kernel against the plain
    # route; their forwards differ by the kernel's 3xTF32 rounding, so the
    # fp32 allowance applies
    m = pair[0].eval()
    b = batch.to(dev)
    enc = {}
    for fused in (True, False):
        m.obj_encoder.fused = fused
        m.zero_grad(set_to_none=True)
        before = pointnet_kernel.launches
        vlsat_total_loss(m(b, istrain=True), b)[0].backward()
        if pointnet_kernel.launches != before + int(fused):
            fail(f"eval-mode gradient run (fused={fused}) launched "
                 f"{pointnet_kernel.launches - before} fused PointNet kernels")
        enc[fused] = grads_of(m, "obj_encoder.")
    if sorted(enc[True]) != sorted(enc[False]) or not enc[False]:
        fail(f"eval-mode gradients reach {sorted(enc[True])} through the kernel, "
             f"{sorted(enc[False])} through the plain chain")
    enc_gate = grad_gate(enc[True], enc[False], "eval-mode obj_encoder gradient, kernel route",
                         0.995)
    log(f"training: eval-mode obj_encoder gradients through the fused kernel equal the plain "
        f"route's at the gate: {json.dumps(enc_gate)}")
    return {"runs": runs, "profiles": profiles, "fixed_batch_losses": fixed_losses,
            "launches": launches, "card_vs_cpu": card_vs_cpu, "fused_encoder_grads": enc_gate}


class TextTargets:
    """Stand-in CLIP text targets for the rel-mimic loss, looked up per edge
    as the JAX package's TripletTextCache looks them up: one vector per
    sentence (subject, predicate, object), or (subject, object) for an edge
    without a relation, here drawn from one seeded stream the first time
    the sentence is seen (a serial pack sees them in a fixed order); an
    edge's target is the normalised mean of its sentences."""

    def __init__(self, dim: int = 512, seed: int = SEED):
        self.dim = dim
        self._rng = np.random.RandomState(seed)
        self._vecs: dict = {}
        self.seconds = 0.0  # host time spent in lookups

    def _vec(self, key) -> np.ndarray:
        if key not in self._vecs:
            self._vecs[key] = self._rng.randn(self.dim).astype(np.float32)
        return self._vecs[key]

    def __call__(self, gt_class, gt_rels, edge_index) -> np.ndarray:
        t0 = time.monotonic()
        out = np.zeros((len(edge_index), self.dim), np.float32)
        for e, (i, j) in enumerate(edge_index):
            s, o = int(gt_class[i]), int(gt_class[j])
            vecs = [self._vec((s, int(r), o)) for r in np.nonzero(gt_rels[e])[0]]
            v = np.mean(vecs or [self._vec((s, o))], axis=0)
            out[e] = v / max(np.linalg.norm(v), 1e-12)
        self.seconds += time.monotonic() - t0
        return out


class OneBucket:
    """A view of a ResidentScenes that holds one bucket (the batch sweep)."""

    def __init__(self, resident, bucket: int):
        self._resident = resident
        self.buckets = [bucket]

    def __getattr__(self, name):
        return getattr(self._resident, name)


def reset_launches() -> None:
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max

    segment_max.launches = 0
    pointnet_kernel.launches = 0
    pointnet_kernel.launches_v2 = 0


def read_launches() -> dict:
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max

    return {"segment_max": segment_max.launches,
            "pointnet_fused": pointnet_kernel.launches - pointnet_kernel.launches_v2,
            "pointnet_fused_v2": pointnet_kernel.launches_v2}


@contextlib.contextmanager
def wire(dtype: str):
    old = os.environ.get("VLSAT_WIRE_DTYPE")
    os.environ["VLSAT_WIRE_DTYPE"] = dtype
    try:
        yield
    finally:
        if old is None:
            del os.environ["VLSAT_WIRE_DTYPE"]
        else:
            os.environ["VLSAT_WIRE_DTYPE"] = old


def nbytes(batch) -> int:
    return sum(v.numel() * v.element_size() for v in vars(batch).values() if v is not None)


def timed_evaluate(step, state, loader, kw, wire_dtype, save_dir=None) -> tuple:
    """(wall s, metrics) of one evaluate() pass on ``wire_dtype``."""
    from vlsat_tpu_torch.eval.engine import evaluate

    with wire(wire_dtype):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        metrics = evaluate(step, state, loader, save_dir=save_dir, **kw)
        torch.cuda.synchronize()
        return time.monotonic() - t0, metrics


def feed_eval(name, make_loader, step, state, kw, wire_dtype, save_dir, scenes: int) -> dict:
    """One loader through evaluate(): a warm-up pass, a timed pass with the
    launch counters at 0 just before it (its rank lists saved), then a pass
    under torch.profiler for the device busy time.  ``data_feed`` times a
    second pass in the reverse order of the loaders."""
    from vlsat_tpu_torch.data.wire import encode_wire
    from vlsat_tpu_torch.eval.engine import evaluate

    with wire(wire_dtype):
        evaluate(step, state, make_loader(), **kw)
        torch.cuda.synchronize()
        loader = make_loader()
        reset_launches()
        wall, metrics = timed_evaluate(step, state, loader, kw, wire_dtype, save_dir)
        launches = read_launches()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            evaluate(step, state, make_loader(), **kw)
            torch.cuda.synchronize()
        # what crosses host to device per item, from the items' shapes
        items = list(make_loader())
        if getattr(loader, "grouped", False):
            rows = sum(idx.shape[0] for _, _, idx in items)
            h2d = [idx.nbytes for _, _, idx in items]
        elif isinstance(items[0], tuple):
            rows, h2d = len(items), [0] * len(items)
        else:
            rows, h2d = len(items), [nbytes(encode_wire(b)) for b in items]
    busy_ms = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
    if launches["segment_max"] != 4 * rows or launches["pointnet_fused"] != rows \
            or launches["pointnet_fused_v2"]:
        fail(f"data feed, {name}: launches {launches} for {rows} evaluated batches "
             f"(want 4 segment-max and 1 fused PointNet each)")
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or len(metrics) < 56:
        fail(f"data feed, {name}: {len(metrics)} metrics, non-finite: {bad}")
    return {"items": len(items), "evaluated_batches": rows, "scenes": scenes, "walls_s": [wall],
            "device_busy_s": busy_ms / 1e3, "h2d_bytes_per_item": float(np.mean(h2d)),
            "per": "group" if getattr(loader, "grouped", False) else "batch",
            "wire": wire_dtype, "launches": launches, "metrics": metrics}


def rank_lists(save_dir) -> dict:
    return {n: np.load(os.path.join(save_dir, f"{n}.npy"))
            for n in ("topk_pred_list", "topk_triplet_list", "cls_matrix_list")}


def tail_output_diff(step, state, resident, batch: int) -> float:
    """Largest relative difference, over the live rows, between each bucket's
    last batch evaluated alone and padded to ``batch`` rows the way the
    grouped loader pads it (the last scene repeated)."""
    from vlsat_tpu_torch.data.resident import gather_rows

    worst = 0.0
    with torch.inference_mode():
        for b in resident.buckets:
            c = resident.count(b)
            start = (c - 1) // batch * batch
            full = resident.full_batch(b)
            dev = full.obj_points.device
            alone = step(state, gather_rows(full, torch.arange(start, c, device=dev)))
            rows = torch.clamp(torch.arange(start, start + batch, device=dev), max=c - 1)
            padded = step(state, gather_rows(full, rows))
            for k, v in alone.items():
                d = (padded[k][:c - start] - v).abs().max() / v.abs().max().clamp_min(1e-30)
                worst = max(worst, d.item())
    return worst


def feed_split() -> tuple:
    """(root, scans_root, node counts, relation counts) of the data feed's
    PLY split, written under WORK on the first call (later calls with the
    same parameters reuse it)."""
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split, validation_scene_stats

    nodes, rels = validation_scene_stats(FEED_SCANS, seed=SEED + 6)
    root, scans, _ = make_synthetic_split(
        str(WORK / "split"), num_scans=FEED_SCANS, node_counts=nodes, rel_counts=rels,
        vertices_per_inst=VERTS_PER_INST, seed=SEED + 6, write_ply=True,
        background_verts=BG_VERTS)
    return root, scans, nodes, rels


def data_feed(model, dev, cfg) -> dict:
    """Phase 10: the data feed on the card.  Its PLY split stays under WORK
    for phase 11."""
    from vlsat_tpu_torch import native
    from vlsat_tpu_torch.data.dataset import SSGScenes
    from vlsat_tpu_torch.data.packed import PackedLoader, PackedScenes, pack_scenes
    from vlsat_tpu_torch.data.resident import (ResidentEvalLoader, ResidentGroupedEval,
                                               ResidentScenes, epoch_permutations,
                                               split_nbytes)
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import (make_eval_step, make_multi_train_step,
                                            make_resident_multi_train_step, stack_batches)

    shutil.rmtree(WORK, ignore_errors=True)
    out: dict = {}
    # 1. the split, from PLY files, through the native parser into a pack
    t0 = time.monotonic()
    root, scans, nodes, rels = feed_split()
    split_s = time.monotonic() - t0
    ply_bytes = sum(f.stat().st_size for f in Path(scans).rglob("*.ply"))
    lib = native.load()
    if lib is None:
        fail("data feed: the native PLY parser did not build (g++)")
    t0 = time.monotonic()
    for f in sorted(Path(scans).rglob("*.ply")):
        lib.read_ply(str(f))
    parse_s = time.monotonic() - t0
    text = TextTargets()
    scenes = SSGScenes(root, scans, "validation_scans", triplet_text_lookup=text)
    t0 = time.monotonic()
    pack_scenes(scenes, str(WORK / "pack"), seed=SEED)
    pack_s = time.monotonic() - t0
    packed = PackedScenes(str(WORK / "pack"))
    pack_bytes = sum(f.stat().st_size for f in (WORK / "pack").iterdir())
    counts = {b: packed.count(b) for b in packed.buckets}
    if len(packed) != FEED_SCANS or sorted(counts) != [8, 12]:
        fail(f"data feed: pack holds {counts}, want {FEED_SCANS} scenes in buckets 8 and 12")
    out["split"] = {"scans": FEED_SCANS, "nodes": int(sum(nodes)), "relationships": int(sum(rels)),
                    "vertices_per_instance": VERTS_PER_INST, "background_vertices": BG_VERTS,
                    "ply_bytes": ply_bytes, "write_s": split_s, "native_parse_s": parse_s,
                    "pack_s": pack_s, "pack_text_targets_s": text.seconds,
                    "pack_scenes_per_sec": FEED_SCANS / pack_s, "pack_bytes": pack_bytes,
                    "buckets": counts, "text_table_rows": int(packed.text_table.shape[0]),
                    "max_gt": packed.max_gt}
    log(f"data feed: {FEED_SCANS} scans ({sum(nodes)} instances of {VERTS_PER_INST} vertices, "
        f"{BG_VERTS} unlabelled vertices a scan, {sum(rels)} relationships) written as "
        f"{ply_bytes / 1e6:.1f} MB of PLY in {split_s:.1f} s; native parse alone "
        f"{parse_s:.2f} s; parse + prepare + pack in {pack_s:.2f} s ({FEED_SCANS / pack_s:.1f} "
        f"scenes/s on the host, {text.seconds:.2f} s of it in the stand-in text targets), pack "
        f"{pack_bytes / 1e6:.2f} MB, buckets {counts}")

    # 2. the split on the card
    torch.cuda.synchronize()
    t0 = time.monotonic()
    resident = ResidentScenes(packed, device=dev)
    torch.cuda.synchronize()
    place_s = time.monotonic() - t0
    out["resident"] = {"split_nbytes": split_nbytes(packed), "place_s": place_s,
                       "bytes_per_scene": split_nbytes(packed) / len(packed)}
    log(f"data feed: split_nbytes {split_nbytes(packed)} ({split_nbytes(packed) / len(packed):.0f} "
        f"per scene) placed on the card in {place_s * 1e3:.1f} ms")

    # 3. evaluation three ways
    step = make_eval_step(model, device=dev)
    state = model.state_dict()
    vocab = triplet_vocab([packed.batch(b, slice(None)) for b in packed.buckets])
    kw = dict(num_rel_classes=cfg.num_rel_classes, verbose=False, scene_recall=True,
              train_triplet_vocab=vocab)
    loaders = {
        "streaming_f16": (lambda: PackedLoader(packed, BATCH), "float16"),
        "streaming_f32": (lambda: PackedLoader(packed, BATCH), "float32"),
        "resident": (lambda: ResidentEvalLoader(resident, BATCH), "float32"),
        "grouped": (lambda: ResidentGroupedEval(resident, BATCH, group=EVAL_GROUP), "float32"),
    }
    runs, launches = {}, {"segment_max": 0, "pointnet_fused": 0}
    for name, (make, wdt) in loaders.items():
        runs[name] = feed_eval(name, make, step, state, kw, wdt, str(WORK / name), len(packed))
        for k in launches:
            launches[k] += runs[name]["launches"][k]
    for name, (make, wdt) in reversed(loaders.items()):  # the order's share of the spread
        runs[name]["walls_s"].append(timed_evaluate(step, state, make(), kw, wdt)[0])
    for name, run in runs.items():
        wall = float(np.mean(run["walls_s"]))
        run.update(scenes_per_sec=run["scenes"] / wall,
                   device_idle_share=1 - run["device_busy_s"] / wall)
        log(f"data feed, {name}: {run['scenes']} scenes in {run['walls_s'][0]:.3f} / "
            f"{run['walls_s'][1]:.3f} s ({run['scenes_per_sec']:.1f} scenes/s), idle share "
            f"{run['device_idle_share']:.3f}, {run['h2d_bytes_per_item']:.0f} H2D bytes per "
            f"{run['per']}; launches {run['launches']}")
    ref = runs["streaming_f32"]["metrics"]
    diff = lambda name: sorted(k for k, v in runs[name]["metrics"].items()
                               if not (v == ref[k] or (np.isnan(v) and np.isnan(ref[k]))))
    if diff("resident"):
        fail(f"data feed: resident metrics differ from streaming on {diff('resident')}")
    lists = {n: rank_lists(WORK / n) for n in ("streaming_f32", "grouped")}
    mism = {k: int((lists["grouped"][k] != v).sum()) if lists["grouped"][k].shape == v.shape
            else -1 for k, v in lists["streaming_f32"].items()}
    ranks = sum(v.size for v in lists["streaming_f32"].values())
    tail = tail_output_diff(step, state, resident, BATCH)
    out["eval_checks"] = {"resident_equal_to_streaming": True,
                          "grouped_metrics_differing": diff("grouped"),
                          "grouped_rank_mismatches": mism, "ranks_compared": ranks,
                          "tail_batch_output_max_rel_diff": tail,
                          "f16_wire_metrics_differing": diff("streaming_f16")}
    log(f"data feed: resident metrics equal to streaming (f32 wire) on all {len(ref)}; grouped "
        f"metrics differing on {diff('grouped')}, rank-list mismatches {mism} of {ranks}; padded "
        f"tail batches within {tail:.2e} of the unpadded; f16 wire metrics differing on "
        f"{diff('streaming_f16')}")
    if min(mism.values()) < 0 or sum(mism.values()) > 1e-3 * ranks or tail > 1e-5:
        fail(f"data feed: grouped evaluation is more than near-ties away from streaming: "
             f"{out['eval_checks']}")
    out["eval"] = {k: {kk: vv for kk, vv in v.items() if kk != "metrics"} for k, v in runs.items()}

    # 4. training over the resident split, B=8, K=4
    tcfg = MMGNetConfig(fused_pointnet=True)
    spec = make_optimizer(lr=1e-4, max_iteration=1000)
    group = TRAIN_BATCH * TRAIN_GROUP
    perms = list(epoch_permutations(counts, group=group, epoch=0, seed=SEED))
    b0, p0 = perms[0]
    first = {}
    for path in ("resident", "streaming"):
        m = dropout_off(build_mmgnet(tcfg, device=dev, seed=SEED + 7))
        st = create_train_state(m, spec)
        if path == "resident":
            fn = make_resident_multi_train_step(m, spec, batch_size=TRAIN_BATCH,
                                                text_table=packed.text_table, device=dev)
            _, aux = fn(st, resident.full_batch(b0), p0, 0)
        else:
            fn = make_multi_train_step(m, spec, text_table=packed.text_table, device=dev)
            _, aux = fn(st, stack_batches([packed.batch(b0, p0[i:i + TRAIN_BATCH])
                                           for i in range(0, group, TRAIN_BATCH)]), 0)
        first[path] = aux["losses"].cpu().double()
    rel = ((first["resident"] - first["streaming"]).abs() / first["streaming"].abs()).max().item()
    if not rel <= 1e-6:
        fail(f"data feed: resident multi-step losses {first['resident'].tolist()} against "
             f"streaming {first['streaming'].tolist()} (max rel {rel:.2e} > 1e-6)")
    log(f"data feed: first group's losses (bucket {b0}, K={TRAIN_GROUP}, B={TRAIN_BATCH}, dropout "
        f"off) resident {first['resident'].tolist()} / streaming {first['streaming'].tolist()}, "
        f"max rel diff {rel:.2e}")
    train = {"first_group_losses": {k: v.tolist() for k, v in first.items()},
             "first_group_max_rel_diff": rel, "groups_per_epoch": len(perms)}
    runners = {}
    for path in ("resident", "streaming"):
        m = build_mmgnet(tcfg, device=dev, seed=SEED + 8)
        st = create_train_state(m, spec)
        if path == "resident":
            fn = make_resident_multi_train_step(m, spec, batch_size=TRAIN_BATCH,
                                                text_table=packed.text_table, device=dev)
            runners[path] = functools.partial(
                lambda fn, st, b, p, i: fn(st, resident.full_batch(b), p, i), fn, st)
        else:
            fn = make_multi_train_step(m, spec, text_table=packed.text_table, device=dev)
            runners[path] = functools.partial(lambda fn, st, b, p, i: fn(st, stack_batches(
                [packed.batch(b, p[j:j + TRAIN_BATCH]) for j in range(0, group, TRAIN_BATCH)]),
                i), fn, st)
        for b, p in {b: p for b, p in perms}.items():  # warm-up: one group per bucket
            runners[path](b, p, 0)
    walls = {path: [] for path in runners}
    steps = len(perms) * TRAIN_GROUP
    for path in ("resident", "streaming", "streaming", "resident"):  # epochs 1-2 of each
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses = [runners[path](b, p, i)[1]["loss"] for i, (b, p) in enumerate(perms)]
        torch.cuda.synchronize()
        walls[path].append(time.monotonic() - t0)
        if any(read_launches().values()):
            fail(f"data feed: training launched kernels {read_launches()}")
        losses = torch.stack(losses).cpu()
        if not torch.isfinite(losses).all():
            fail(f"data feed: non-finite training losses on the {path} path")
        train.setdefault(f"{path}_epoch_losses", []).append([losses[0].item(), losses[-1].item()])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for path, run in runners.items():
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for i, (b, p) in enumerate(perms[:3]):
            run(b, p, i)
        torch.cuda.synchronize()
        plain_wall = time.monotonic() - t1
        with torch.profiler.profile(activities=acts) as prof:
            for i, (b, p) in enumerate(perms[:3]):
                run(b, p, i)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e6
        wall = float(np.mean(walls[path]))
        train[path] = {"steps": steps, "scenes": steps * TRAIN_BATCH, "walls_s": walls[path],
                       "scenes_per_sec": steps * TRAIN_BATCH / wall,
                       "step_wall_ms": wall * 1e3 / steps,
                       "device_busy_ms_per_step": busy * 1e3 / (3 * TRAIN_GROUP),
                       "device_idle_share": 1 - busy / plain_wall,
                       "h2d_bytes_per_call": (p0.nbytes if path == "resident" else nbytes(
                           stack_batches([packed.batch(b0, p0[j:j + TRAIN_BATCH])
                                          for j in range(0, group, TRAIN_BATCH)])))}
        log(f"data feed, training ({path}): {steps} steps, {steps * TRAIN_BATCH} scenes in "
            f"{walls[path][0]:.2f} / {walls[path][1]:.2f} s ({steps * TRAIN_BATCH / wall:.1f} "
            f"scenes/s, {wall * 1e3 / steps:.2f} ms a step), idle share "
            f"{train[path]['device_idle_share']:.3f}, epoch losses "
            f"{train[f'{path}_epoch_losses']}")
    out["train"] = train

    # 5. eval batch sizes over the grouped resident path, per bucket
    sweep = {}
    with wire("float32"):
        for b in sorted(counts):
            view = OneBucket(resident, b)
            for bs in (16, 32, 64):
                make = lambda: ResidentGroupedEval(view, bs, group=EVAL_GROUP)
                evaluate(step, state, make(), **kw)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                walls = []
                for _ in range(3):
                    t0 = time.monotonic()
                    evaluate(step, state, make(), **kw)
                    torch.cuda.synchronize()
                    walls.append(time.monotonic() - t0)
                sweep[f"{b}/{bs}"] = {"bucket": b, "batch": bs, "scenes": counts[b],
                                      "walls_s": walls,
                                      "scenes_per_sec": counts[b] / float(np.median(walls)),
                                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
                log(f"data feed, eval batch sweep: bucket {b}, B={bs}: "
                    f"{counts[b] / float(np.median(walls)):.1f} scenes/s (median of 3)")
    best = {b: max((v for v in sweep.values() if v["bucket"] == b),
                   key=lambda v: v["scenes_per_sec"])["batch"] for b in counts}
    out["eval_batch_sweep"] = {"runs": sweep, "best": best}
    log(f"data feed: fastest eval batch per bucket {best}")
    out["launches"] = launches
    return out


def http_request(port: int, path: str, body: bytes = None, timeout: float = 120.0) -> tuple:
    """(status, body) of one request to the serve subprocess."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def eval_rows(packed, batch_spec, group: int) -> int:
    """Batches one grouped resident validation pass computes: each bucket's
    batches, rounded up to whole groups of ``group``."""
    from vlsat_tpu_torch.data.bucket_batch import resolve_batch

    rows = 0
    for b in packed.buckets:
        batches = -(-packed.count(b) // resolve_batch(batch_spec, b))
        rows += -(-batches // group) * group
    return rows


def differing_metrics(a: dict, b: dict) -> list:
    """Keys on which two metric dicts differ (NaN equal to NaN)."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b
                  or not (a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k]))))


def serve_clients(port: int, payloads: list, seconds: float, clients: int) -> dict:
    """``clients`` threads post random payloads back to back for ``seconds``."""
    lat, errors = [], []
    lock = threading.Lock()
    stop = time.monotonic() + seconds

    def client(i):
        rng = np.random.RandomState(100 + i)
        local = []
        try:
            while time.monotonic() < stop:
                t0 = time.monotonic()
                code, body = http_request(port, "/predict", payloads[rng.randint(len(payloads))])
                local.append(time.monotonic() - t0)
                if code != 200:
                    raise RuntimeError(f"/predict answered {code}: {body[:200]!r}")
        except Exception as e:  # reported below, fails the run
            errors.append(e)
        with lock:
            lat.extend(local)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 300)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"runner, serve: clients failed: {errors[:3]!r}")
    arr = np.asarray(lat) * 1e3
    return {"requests": len(lat), "wall_s": wall, "scenes_per_sec": len(lat) / wall,
            "p50_latency_ms": float(np.percentile(arr, 50)),
            "p99_latency_ms": float(np.percentile(arr, 99)), "clients": clients}


def runner(dev) -> dict:
    """Phase 11: the runner and the CLI on the card, over phase 10's split."""
    import signal

    from vlsat_tpu_torch.clipsem import HashTextEncoder, TripletTextCache
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.data.assets import build_index, read_classes, read_relationships
    from vlsat_tpu_torch.data.bucket_batch import DEFAULT_EVAL_BATCH
    from vlsat_tpu_torch.data.dataset import SSGScenes
    from vlsat_tpu_torch.data.packed import PackedScenes
    from vlsat_tpu_torch.main import main as cli
    from vlsat_tpu_torch.serving import BatchedServer
    from vlsat_tpu_torch.train.checkpoint import CheckpointManager
    from vlsat_tpu_torch.train.runner import Runner

    root, scans, _, _ = feed_split()
    shutil.rmtree(RUN_WORK, ignore_errors=True)
    RUN_WORK.mkdir(parents=True)
    out: dict = {}
    # 1. the triplet text cache over the train split
    t0 = time.monotonic()
    index = build_index(root, "train_scans")
    cache = TripletTextCache(read_classes(root), read_relationships(root)[1:])
    sentences = cache.sentences_for_index(index.scenes)
    cache.build(sentences, HashTextEncoder())
    cache.save(str(RUN_WORK / "triplets.npz"))
    out["text_cache"] = {"sentences": len(sentences), "build_s": time.monotonic() - t0}
    # 2. one experiment JSON at the full MODEL width
    cfg_path = RUN_WORK / "cfg.json"
    cfg_path.write_text(json.dumps({
        "NAME": "Mmgnet", "PATH": str(RUN_WORK / "out"), "SEED": SEED, "Batch_Size": TRAIN_BATCH,
        "MAX_EPOCHES": RUNNER_EPOCHS, "VALID_INTERVAL": 1, "LOG_INTERVAL": 10,
        "EVAL_BATCH_SIZE": "auto", "TRAIN_MICROSTEPS": TRAIN_GROUP, "TRAIN_RESIDENT": "auto",
        "EVAL_RESIDENT": "auto", "EVAL_GROUP": EVAL_GROUP,
        "MODEL": {"triplet_text_cache": str(RUN_WORK / "triplets.npz")},
        "dataset": {"root": root, "scans_root": scans, "packed_root": str(RUN_WORK / "pack")}}))
    cfg = load_config(str(cfg_path))
    here = Path(__file__).resolve().parent
    # 3. the pack tool, as a user runs it
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "vlsat_tpu_torch.tools.pack_dataset",
                          "--config", str(cfg_path)], cwd=here, capture_output=True, text=True,
                         timeout=600)
    out["pack_s"] = time.monotonic() - t0
    if res.returncode:
        fail(f"runner: pack_dataset exited {res.returncode}: {res.stderr[-2000:]}")
    valid = PackedScenes(str(RUN_WORK / "pack" / "validation"))
    train_pack = PackedScenes(str(RUN_WORK / "pack" / "train"))
    rows = eval_rows(valid, DEFAULT_EVAL_BATCH, EVAL_GROUP)
    out["pack"] = {"train_scenes": len(train_pack), "validation_scenes": len(valid),
                   "text_table_rows": int(train_pack.text_table.shape[0]),
                   "eval_rows_per_validation": rows}
    log(f"runner: text cache of {len(sentences)} sentences in "
        f"{out['text_cache']['build_s']:.2f} s; pack_dataset in {out['pack_s']:.1f} s "
        f"({len(train_pack)} train / {len(valid)} validation scenes)")

    # 4. train through the CLI's entry, with every launch counter at 0 just before
    exp = Path(cfg.PATH) / "Mmgnet" / "default"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    train_metrics = cli(["--config", str(cfg_path), "--mode", "train"])
    out["train_command_s"] = time.monotonic() - t0
    train_launches = read_launches()
    validations = RUNNER_EPOCHS + 1  # one per epoch, then the closing validation(save=True)
    if train_launches != {"segment_max": 4 * rows * validations, "pointnet_fused": 0,
                          "pointnet_fused_v2": 0}:
        fail(f"runner, train: launches {train_launches}; want {4 * rows * validations} "
             f"segment-max ({validations} validations of {rows} batches, 4 each, none in a "
             "train step) and no PointNet")
    with open(exp / "epoch_stats.jsonl") as f:
        epochs = [json.loads(line) for line in f]
    if len(epochs) != RUNNER_EPOCHS or any(
            not (r.get("scenes_per_sec", 0) > 0 and r.get("hbm_peak_mb", 0) > 0) for r in epochs):
        fail(f"runner, train: epoch rows {epochs}")
    with open(Path(cfg.PATH) / "logs" / "Mmgnet" / "default" / "events.jsonl") as f:
        losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
    if not losses or not np.isfinite(losses).all():
        fail(f"runner, train: logged train/loss {losses}")
    ckpt = CheckpointManager(str(exp / "checkpoints"))
    result_txt = Path(cfg.PATH) / "results" / "Mmgnet" / "default" / "result.txt"
    if ckpt.latest_step is None or ckpt.best_step is None or not result_txt.exists():
        fail(f"runner, train: latest {ckpt.latest_step}, best {ckpt.best_step}, "
             f"result.txt {result_txt.exists()}")
    out["epochs"] = [{**r, "train_only_scenes_per_sec": r["scenes"] / (r["wall_s"] - r["val_wall_s"]),
                      "val_scenes_per_sec": len(valid) / r["val_wall_s"]} for r in epochs]
    out["train"] = {"steps": ckpt.latest_step, "logged_losses": [losses[0], losses[-1]],
                    "launches": train_launches, "peak_memory_gib":
                    torch.cuda.max_memory_allocated() / 2**30}
    for r in out["epochs"]:
        log(f"runner, train epoch {r['epoch']}: {r['scenes']} scenes, wall {r['wall_s']} s "
            f"with validation ({r['scenes_per_sec']} scenes/s; "
            f"{r['train_only_scenes_per_sec']:.1f} without), validation {r['val_wall_s']} s "
            f"({r['val_scenes_per_sec']:.1f} scenes/s), peak {r['hbm_peak_mb']} MB")

    # 5. eval through the CLI's entry on the latest checkpoint: the same metrics
    reset_launches()
    t0 = time.monotonic()
    eval_metrics = cli(["--config", str(cfg_path), "--mode", "eval"])
    out["eval_command_s"] = time.monotonic() - t0
    eval_launches = read_launches()
    differ = differing_metrics(eval_metrics, train_metrics)
    if differ or eval_launches["segment_max"] != 4 * rows or eval_launches["pointnet_fused"]:
        fail(f"runner, eval: metrics differing from the closing validation on {differ}; "
             f"launches {eval_launches} (want {4 * rows} segment-max)")
    out["eval"] = {"metrics": len(eval_metrics), "launches": eval_launches,
                   "mean_recall_50": eval_metrics["mean_recall_50"],
                   "command_scenes_per_sec": len(valid) / out["eval_command_s"]}
    log(f"runner, eval: {len(eval_metrics)} metrics equal to the closing validation's; "
        f"command {out['eval_command_s']:.1f} s; launches {eval_launches}")

    # 6. serve through the CLI in a subprocess, held against the CPU
    vs = SSGScenes(root, scans, "validation_scans")
    picks = [vs.prepare(i, np.random.RandomState(i)) for i in range(0, len(vs), 17)]
    payloads = [npz_bytes(**{f: p[f] for f in PAYLOAD}) for p in picks]
    proc = subprocess.Popen([sys.executable, "-m", "vlsat_tpu_torch.main", "--mode", "serve",
                             "--port", "0", "--config", str(cfg_path)], cwd=here,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    ready = threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on http://"):
                ready.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        t0 = time.monotonic()
        if not ready.wait(timeout=300):
            fail(f"runner, serve: no 'serving on' line; output {''.join(lines)[-2000:]}")
        startup_s = time.monotonic() - t0
        line = next(l for l in lines if l.startswith("serving on http://"))
        port = int(line.split("http://", 1)[1].split()[0].rsplit(":", 1)[1])
        # the first 4 scenes one at a time: the server's first batches (its
        # CUDA start) stay out of the timed load, and their answers are checked
        answers, first_ms = [], []
        for body in payloads[:4]:
            t0 = time.monotonic()
            code, got = http_request(port, "/predict", body)
            first_ms.append((time.monotonic() - t0) * 1e3)
            if code != 200:
                fail(f"runner, serve: /predict answered {code}: {got[:200]!r}")
            with np.load(io.BytesIO(got)) as z:
                answers.append({f: z[f] for f in z.files})
        bench = serve_clients(port, payloads, RUNNER_HTTP_S, RUNNER_CLIENTS)
        code, health = http_request(port, "/healthz")
        health = json.loads(health)
        if code != 200 or health["scenes"] != bench["requests"] + len(answers):
            fail(f"runner, serve: /healthz {code} {health} after "
                 f"{bench['requests'] + len(answers)} requests")
        code, err = http_request(port, "/predict", npz_bytes(obj_points=picks[0]["obj_points"]))
        if code != 400 or not json.loads(err)["error"].startswith("ValueError"):
            fail(f"runner, serve: a payload without descriptor got {code} {err[:200]!r}")
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            fail("runner, serve: the server did not stop within 30 s of SIGINT")
        if rc != 0:
            fail(f"runner, serve: exit code {rc} after SIGINT; output {''.join(lines)[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    reader.join(timeout=10)
    cpu = Runner(load_config(str(cfg_path), {"MODE": "serve"}), device="cpu")
    try:
        if not cpu.load():
            fail("runner, serve: no checkpoint for the CPU reference")
        with BatchedServer(cpu.model, cpu.state.model.state_dict(), device="cpu",
                           branch_3d_only=False, max_batch=1, pad_to_max=False,
                           buckets=tuple(cfg.dataset.node_buckets),
                           num_rel_classes=cpu.num_rel) as server:
            for k, got in enumerate(answers):
                want = server.predict({f: picks[k][f] for f in PAYLOAD}, timeout=600)
                for key in ("obj_logits", "rel_cls"):
                    if not np.allclose(got[key], want[key], rtol=1e-3, atol=1e-4):
                        fail(f"runner, serve: {key} of scene {k} differs from the CPU: max abs "
                             f"{np.abs(got[key] - want[key]).max()}")
    finally:
        cpu.close()
    out["serve"] = {**bench, "startup_s": startup_s, "first_requests_ms": first_ms,
                    "batches": health["batches"],
                    "mean_batch_size": health["mean_batch_size"], "exit_code": rc}
    log(f"runner, serve: first 4 requests alone in {[round(t, 1) for t in first_ms]} ms; "
        f"then {bench['requests']} requests from {RUNNER_CLIENTS} clients in "
        f"{bench['wall_s']:.1f} s ({bench['scenes_per_sec']:.1f} scenes/s, p50 "
        f"{bench['p50_latency_ms']:.1f} / p99 {bench['p99_latency_ms']:.1f} ms, mean batch "
        f"{health['mean_batch_size']:.1f}); answers for 4 scenes match the CPU (rtol 1e-3, "
        f"atol 1e-4); 400 on a bad payload; exit 0 after SIGINT")
    out["launches"] = {k: train_launches[k] + eval_launches[k] for k in train_launches}
    return out


# segment-max launches of one eval forward, per registry entry: one per
# GraphEdgeAttenNetwork layer (depth 2), both towers of the teacher/student
# and both branches of in21k; SGPN has no graph network, and the SGGpoint
# family aggregates by mean and add (EdgeGCN), never by max
VARIANTS = {"MmgnetSingle": 2, "SGFN": 2, "SGPN": 0, "MMteacher": 4, "MmgnetIn21k": 4,
            "SGGpoint": 0, "SGGpointBaseline": 0}
VARIANT_TRAIN_STEPS = 10
NUM_POINTS_UNION = 256     # the JAX config's num_points_union


def variant_splits(name: str) -> dict:
    """Phase 8's 3DSSG-like split (B=32, buckets 8/12) and B=8 train
    batches with text targets, with 768-d 2D features for in21k and union
    clouds for SGPN."""
    kw = dict(feat_dim=768 if name == "MmgnetIn21k" else 512,
              num_points_union=NUM_POINTS_UNION if name == "SGPN" else 0)
    return {"eval": labelled_splits(SEED + 2, large=(), **kw)["val"],
            "train": labelled_splits(SEED + 3, batch=TRAIN_BATCH, large=(), with_text=True,
                                     **kw)["val"]}


def variant_model(name: str, dev, seed: int):
    """The registry's model and loss at the default MODEL section, with
    weights drawn from ``seed`` on ``dev``."""
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.models.mmgnet import init_parameters
    from vlsat_tpu_torch.models.registry import build_model

    model, loss = build_model(name, 160, 26, load_config().MODEL)
    model.to(dev)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval(), loss


def variant_run(name: str, dev) -> dict:
    """One registry entry on the card: evaluation, forward and ranks
    against the CPU, timed train steps, a falling loss and the fp64 step
    against the CPU."""
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_eval_step, make_train_step

    splits = variant_splits(name)
    val, train = splits["eval"], splits["train"]
    per_fwd = VARIANTS[name]
    model, loss = variant_model(name, dev, SEED + 10)
    step = make_eval_step(model, device=dev)
    state = model.state_dict()
    kw = dict(num_rel_classes=26, verbose=False, scene_recall=True,
              train_triplet_vocab=triplet_vocab(val))
    evaluate(step, state, val, **kw)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    metrics = evaluate(step, state, val, **kw)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    nb, scenes = len(val), sum(b.num_scenes for b in val)
    if launches != {"segment_max": per_fwd * nb, "pointnet_fused": 0, "pointnet_fused_v2": 0}:
        fail(f"variants, {name}: evaluation launched {launches} for {nb} batches "
             f"(want {per_fwd * nb} segment-max, no PointNet)")
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or len(metrics) < 56:
        fail(f"variants, {name}: {len(metrics)} metrics, non-finite: {bad}")
    out = {"eval": {"scenes": scenes, "batches": nb, "wall_s": wall,
                    "scenes_per_sec": scenes / wall, "wall_ms_per_batch": wall * 1e3 / nb,
                    "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": launches, "mean_recall_50": metrics["mean_recall_50"]}}
    knn = name.startswith("SGGpoint")
    out["checks"] = [check_eval_batch(model, state, dev, b, knn=knn) for b in val[:2]]
    out["eval_profile"] = profile_eval(step, state, [b for b in val if b.num_nodes == 12])

    # train steps at B=8 with the registry's loss and text targets
    spec = make_optimizer(lr=1e-4, max_iteration=1000)
    tstate = create_train_state(model, spec)
    tstep = make_train_step(model, spec, objective=loss, device=dev)
    for b in {b.num_nodes: b for b in train}.values():  # warm-up, one step per shape
        tstep(tstate, b, 0)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    batches = train[:VARIANT_TRAIN_STEPS]
    t0 = time.monotonic()
    losses = torch.stack([tstep(tstate, b, i)[1]["loss"] for i, b in enumerate(batches)]).cpu()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    train_launches = read_launches()
    if any(train_launches.values()) or not torch.isfinite(losses).all():
        fail(f"variants, {name}: train steps launched {train_launches} (want none), "
             f"losses {losses.tolist()}")
    tscenes = sum(b.num_scenes for b in batches)
    out["train"] = {"steps": len(batches), "scenes": tscenes,
                    "step_wall_ms": wall * 1e3 / len(batches), "scenes_per_sec": tscenes / wall,
                    "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["train_profile"] = profile_train(tstep, tstate,
                                         [b for b in train if b.num_nodes == 12][:6])

    # the loss falls over 8 steps on one repeated batch
    fixed, _ = variant_model(name, dev, SEED + 11)
    fstate = create_train_state(fixed, spec)
    fstep = make_train_step(fixed, spec, objective=loss, device=dev)
    fixed_losses = torch.stack([fstep(fstate, train[0], 0)[1]["loss"]
                                for _ in range(8)]).cpu().tolist()
    if not fixed_losses[-1] < fixed_losses[0]:
        fail(f"variants, {name}: the loss did not fall over 8 steps on one batch: "
             f"{fixed_losses}")
    out["fixed_batch_losses"] = [fixed_losses[0], fixed_losses[-1]]

    # one fp64 step on the card and on the CPU from identical weights, dropout off
    batch = train[-1]  # batches come in bucket order: the last is at bucket 12
    pair = [dropout_off(variant_model(name, d, SEED + 12)[0]).double() for d in (dev, "cpu")]
    step_losses, sets = [], []
    for m, d in zip(pair, (dev, "cpu")):
        st = create_train_state(m, spec)
        with knn_sets() as calls:
            _, aux = make_train_step(m, spec, objective=loss, device=d)(
                st, as_dtype(batch, torch.float64), 0)
        step_losses.append(aux["loss"].item())
        sets.append(calls)
    if not np.isclose(step_losses[0], step_losses[1], rtol=1e-4, atol=0):
        fail(f"variants, {name}: fp64 train step loss on the card {step_losses[0]} != CPU "
             f"{step_losses[1]} (rtol 1e-4)")
    flipped = int(knn_mismatches(*sets, batch.obj_mask).sum())
    if flipped:
        fail(f"variants, {name}: {flipped} (point, stage) neighbour sets of the fp64 train "
             "step differ between the card and the CPU")
    out["fp64_step"] = {"loss": step_losses, "knn_stages": len(sets[0]),
                        "knn_set_mismatches": flipped, "gradients": grad_gate(
        grads_of(pair[0]), grads_of(pair[1]), f"variants, {name}: fp64 train step")}
    e, t = out["eval"], out["train"]
    flips = (f" ({sum(c['knn_set_mismatches'] for c in out['checks'])} of "
             f"{sum(c['knn_point_rows'] for c in out['checks'])} (point, stage) neighbour "
             f"sets differ; outputs gated on {sum(c['scenes_gated'] for c in out['checks'])} "
             f"of {sum(c['scenes'] for c in out['checks'])} scenes; fp64: none)" if knn else "")
    log(f"variants, {name}: evaluated {e['scenes']} scenes at {e['scenes_per_sec']:.1f} "
        f"scenes/s ({e['wall_ms_per_batch']:.2f} ms a batch, segment-max "
        f"{launches['segment_max']} for {nb} batches); card forward and ranks equal the "
        f"CPU's on 2 batches{flips}; trained {t['scenes_per_sec']:.1f} scenes/s "
        f"({t['step_wall_ms']:.2f} ms a step, no kernel launch); loss "
        f"{fixed_losses[0]:.4f} -> {fixed_losses[-1]:.4f} in 8 steps; fp64 step card against "
        f"CPU: loss {step_losses[0]:.9g} / {step_losses[1]:.9g}, every gradient leaf at the gate")
    return out


def reference_module_files(directory: Path, seed: int) -> None:
    """Per-module ``.pth`` files of a reference ``Mmgnet`` checkpoint
    (BaseModel.save naming and Sequential indices, as
    tests/test_torch_import.py fabricates them) at full width, with seeded
    weights scaled by 1/sqrt(fan-in) and positive BatchNorm variances."""
    g = torch.Generator().manual_seed(seed)
    d, h, da = 512, 8, 256
    dn, do = d // h, da // h

    def lin(prefix, din, dout):
        p = f"{prefix}." if prefix else ""
        return {f"{p}weight": torch.randn(dout, din, generator=g) / din ** 0.5,
                f"{p}bias": 0.1 * torch.randn(dout, generator=g)}

    def norm(prefix, n, stats=False):
        out = {f"{prefix}.weight": 1 + 0.1 * torch.randn(n, generator=g),
               f"{prefix}.bias": 0.1 * torch.randn(n, generator=g)}
        if stats:
            out[f"{prefix}.running_mean"] = 0.5 * torch.randn(n, generator=g)
            out[f"{prefix}.running_var"] = 0.5 + torch.rand(n, generator=g)
        return out

    def many(*parts):
        return {k: v for part in parts for k, v in part.items()}

    pointnet = lambda cin, cout: many(lin("conv1", cin, 64), lin("conv2", 64, 128),
                                      lin("conv3", 128, cout))
    mha = lambda p: many(*(lin(f"{p}.attention.fc_{x}", d, d) for x in "qkvo"),
                         norm(f"{p}.layer_norm", d))
    gean = lambda p: many(
        lin(f"{p}.edgeatten.nn_edge.0", 3 * d, 2 * d), lin(f"{p}.edgeatten.nn_edge.2", 2 * d, d),
        lin(f"{p}.edgeatten.proj_query.0", d, d), lin(f"{p}.edgeatten.proj_edge.0", d, d),
        lin(f"{p}.edgeatten.proj_value.0", d, da), lin(f"{p}.edgeatten.nn.0", 2 * dn, 2 * dn),
        lin(f"{p}.edgeatten.nn.3", 2 * dn, do), lin(f"{p}.prop.0", d + da, d + da),
        lin(f"{p}.prop.2", d + da, d))
    mmg = many(lin("self_attn_fc.0", 4, 32), norm("self_attn_fc.2", 32),
               lin("self_attn_fc.3", 32, 32), norm("self_attn_fc.5", 32),
               lin("self_attn_fc.6", 32, h),
               *(mha(f"{m}.{i}") for i in range(2)
                 for m in ("self_attn", "cross_attn", "cross_attn_rel")),
               *(gean(f"{m}.{i}") for i in range(2) for m in ("gcn_3ds", "gcn_2ds")))
    rel = lambda: many(lin("fc1", d, 512), lin("fc2", 512, 256), lin("fc3", 256, 26))
    modules = {
        "obj_encoder": pointnet(3, 768), "rel_encoder_2d": pointnet(11, d),
        "rel_encoder_3d": pointnet(11, d), "mmg": mmg,
        "clip_adapter": many(lin("fc1", d, 256), lin("fc2", 256, d)),
        "rel_predictor_2d": rel(), "rel_predictor_3d": rel(),
        "obj_predictor_2d": lin("", d, 160), "obj_predictor_3d": lin("", d, 160),
        "mlp_3d": many(lin("0", 768, 504), norm("1", 504, stats=True)),
        "triplet_projector_2d": many(lin("0", 3 * d, 1024), lin("3", 1024, d)),
        "obj_logit_scale": {"obj_logit_scale": torch.tensor(float(np.log(1 / 0.07)))},
    }
    directory.mkdir(parents=True, exist_ok=True)
    for name, sd in modules.items():
        torch.save(sd, directory / f"{name}.pth")


def variants(dev) -> dict:
    """Phase 12: the model zoo on the card."""
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.data.bucket_batch import DEFAULT_EVAL_BATCH
    from vlsat_tpu_torch.data.packed import PackedScenes
    from vlsat_tpu_torch.interop.torch_import import import_from_directory, to_state_dict
    from vlsat_tpu_torch.main import main as cli
    from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig
    from vlsat_tpu_torch.train.step import make_eval_step

    out: dict = {"models": {}}
    for name in VARIANTS:
        t0 = time.monotonic()
        out["models"][name] = variant_run(name, dev)
        out["models"][name]["phase_s"] = time.monotonic() - t0

    # the CLI on SGFN over phase 11's pack: train one epoch, then eval
    cfg_json = json.loads((RUN_WORK / "cfg.json").read_text())
    cfg_json.update(NAME="SGFN", MAX_EPOCHES=1, PATH=str(RUN_WORK / "sgfn"))
    cfg_path = RUN_WORK / "sgfn.json"
    cfg_path.write_text(json.dumps(cfg_json))
    rows = eval_rows(PackedScenes(str(RUN_WORK / "pack" / "validation")), DEFAULT_EVAL_BATCH,
                     EVAL_GROUP)
    reset_launches()
    t0 = time.monotonic()
    train_metrics = cli(["--config", str(cfg_path), "--mode", "train"])
    train_s = time.monotonic() - t0
    train_launches = read_launches()
    if train_launches != {"segment_max": 2 * rows * 2, "pointnet_fused": 0,
                          "pointnet_fused_v2": 0}:
        fail(f"variants, SGFN train command: launches {train_launches}; want {4 * rows} "
             f"segment-max (2 validations of {rows} batches, 2 each)")
    reset_launches()
    t0 = time.monotonic()
    eval_metrics = cli(["--config", str(cfg_path), "--mode", "eval"])
    eval_s = time.monotonic() - t0
    eval_launches = read_launches()
    differ = differing_metrics(eval_metrics, train_metrics)
    if differ or eval_launches["segment_max"] != 2 * rows:
        fail(f"variants, SGFN eval command: metrics differing from the closing validation "
             f"on {differ}; launches {eval_launches} (want {2 * rows} segment-max)")
    exp = Path(cfg_json["PATH"]) / "SGFN" / "default"
    with open(exp / "epoch_stats.jsonl") as f:
        epoch = json.loads(f.readline())
    if epoch["step"] <= 0 or not epoch["scenes_per_sec"] > 0:
        fail(f"variants, SGFN train command: epoch row {epoch}")
    out["cli_sgfn"] = {"train_command_s": train_s, "eval_command_s": eval_s,
                       "metrics": len(eval_metrics), "launches_train": train_launches,
                       "launches_eval": eval_launches, "epoch": epoch,
                       "mean_recall_50": eval_metrics["mean_recall_50"]}
    log(f"variants, SGFN through the CLI: train {train_s:.1f} s (epoch {epoch}), eval "
        f"{eval_s:.1f} s with {len(eval_metrics)} metrics equal to the closing validation's; "
        f"segment-max {train_launches['segment_max']} / {eval_launches['segment_max']}")

    # a reference checkpoint directory imported onto the card
    pth = RUN_WORK / "reference_pth"
    reference_module_files(pth, SEED + 13)
    t0 = time.monotonic()
    variables = import_from_directory(str(pth))
    card = MMGNet(MMGNetConfig()).to(dev)
    card.load_state_dict(to_state_dict(variables, card))
    cpu = MMGNet(MMGNetConfig())
    cpu.load_state_dict(to_state_dict(variables, cpu))
    import_s = time.monotonic() - t0
    batch = labelled_splits(SEED + 14, large=())["val"][0]
    got = make_eval_step(card.eval(), device=dev)(card.state_dict(), batch)
    want = make_eval_step(cpu.eval(), device="cpu")(cpu.state_dict(), batch)
    masks = {"obj": batch.obj_mask, "rel": batch.edge_mask}
    diffs = {}
    for key, w in want.items():
        g, m = got[key].cpu(), masks[key.split("_")[0]]
        diffs[key] = (g[m] - w[m]).abs().max().item()
        if not (torch.isfinite(g[m]).all() and torch.allclose(g[m], w[m], rtol=1e-3, atol=1e-4)):
            fail(f"variants, imported checkpoint: {key} on the card differs from the CPU: "
                 f"max abs {diffs[key]}")
    out["import"] = {"modules": len(list(pth.glob("*.pth"))), "import_s": import_s,
                     "max_abs_diff": diffs}
    log(f"variants, reference .pth import: {out['import']['modules']} module files onto the "
        f"card in {import_s:.2f} s; dual forward equals the CPU's (max abs {max(diffs.values()):.3g})")
    out["launches"] = {k: sum(m["eval"]["launches"][k] for m in out["models"].values())
                       for k in train_launches}
    return out

EXPORT_WORK = WORK.parent / "export"
EXPORT_BUCKETS = (16, 48)  # the serving buckets of phase 5's 4-40-node scenes
# the artifact's outputs against the live eval step, and its kernel
# launches, in a process that imports no module of vlsat_tpu_torch.models
RELOAD = """
import json, sys, time
import torch
from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.serving_export import load_serving_artifact
art, inputs, out_path = sys.argv[1:4]
t0 = time.perf_counter()
step = load_serving_artifact(art, device="cuda")
load_s = time.perf_counter() - t0
outs, launches = [], []
for fields in torch.load(inputs):
    before = (segment_max.launches, pointnet_kernel.launches)
    out = step(None, SceneBatch(**fields))
    torch.cuda.synchronize()
    launches.append([segment_max.launches - before[0], pointnet_kernel.launches - before[1]])
    outs.append({k: v.cpu() for k, v in out.items()})
torch.save({"outs": outs, "launches": launches, "load_s": load_s,
            "models": sorted(m for m in sys.modules if m.startswith("vlsat_tpu_torch.models"))},
           out_path)
"""


# one evaluation under utils.profiling.trace in a fresh process, where
# torch.profiler keeps every kernel record (late in a long process it loses
# the first ones of a session: PERF.md §7)
PROFILE = """
import json, sys
import torch
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.train.step import make_eval_step
from vlsat_tpu_torch.utils import profiling
torch.backends.cuda.matmul.allow_tf32 = False
inputs, log_dir = sys.argv[1:3]
saved = torch.load(inputs)
model = build_mmgnet(MMGNetConfig(fused_pointnet=True), device="cuda", seed=0)
model.load_state_dict(saved["state"])
batches = [SceneBatch(**f) for f in saved["batches"]]
step = make_eval_step(model, device="cuda")
evaluate(step, model.state_dict(), batches, verbose=False)
torch.cuda.synchronize()
before = (segment_max.launches, pointnet_kernel.launches)
with profiling.trace(log_dir) as path:
    evaluate(step, model.state_dict(), batches, verbose=False)
    torch.cuda.synchronize()
print(json.dumps({"path": path,
                  "profiled": [segment_max.launches - before[0], pointnet_kernel.launches - before[1]],
                  "total": [segment_max.launches, pointnet_kernel.launches]}))
"""


def trace_counts(path) -> dict:
    """A Chrome trace's kernel records of each kernel, all its kernel
    records and all its launch calls (the CUDA API launch events, which
    the profiler records on the host)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [str(e.get("name")) for e in events if e.get("cat") == "kernel"]
    return {"segment_max": sum("segment_max_kernel" in n for n in names),
            "pointnet_fused": sum("pointnet_kernel" in n for n in names),
            "kernel_records": len(names),
            "launch_calls": sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                                and "Launch" in str(e.get("name")) for e in events)}


def serving_batch(scenes: list, bucket: int):
    """BATCH of the scenes that fit ``bucket`` (cycled to fill the batch),
    padded to it, as a host f32 batch."""
    from vlsat_tpu_torch.scene import collate, full_edge_index, pad_scene

    fit = [s for s in scenes if s["obj_points"].shape[0] <= bucket
           and (bucket == EXPORT_BUCKETS[0] or s["obj_points"].shape[0] > EXPORT_BUCKETS[0])]
    padded = []
    for k in range(BATCH):
        s = fit[k % len(fit)]
        n = s["obj_points"].shape[0]
        ei = full_edge_index(n)
        padded.append(pad_scene(s["obj_points"], s["descriptor"], np.zeros((n, 512), np.float32),
                                np.zeros(n, np.int32), ei, np.zeros((len(ei), 26), np.float32),
                                n_max=bucket))
    return collate(padded)


def dispatch_us(dev) -> dict:
    """Host microseconds a call to enqueue each kernel, through its ctypes
    wrapper and through its PyTorch operator, at bucket 16's shapes (200
    calls back to back, no synchronisation inside; turns direct, operator,
    operator, direct)."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as P
    from vlsat_tpu_torch.ops.kernels import segment_max as S

    rng = np.random.RandomState(SEED + 20)
    data, ei, em = edge_inputs(rng, 16, dev, True)
    pts = torch.from_numpy(rng.randn(BATCH, 16, 128, 3).astype(np.float32)).to(dev)
    dims = (3, 64, 128, 768)
    ws = [torch.from_numpy((rng.randn(b, a) / np.sqrt(a)).astype(np.float32)).to(dev).t()
          for a, b in zip(dims, dims[1:])]
    bs = [torch.zeros(b, device=dev) for b in dims[1:]]
    calls = {"segment_max": (lambda: S.segment_max_cuda(data, ei, em, 16),
                             lambda: S.segment_max(data, ei, em, 16)),
             "pointnet_fused": (lambda: P._launch(pts, ws, bs, 128),
                                lambda: P.pointnet_encode_fused(pts, ws, bs))}
    out = {}
    for name, (direct, op) in calls.items():
        times = {"direct": [], "operator": []}
        with torch.no_grad():
            for kind, fn in (("direct", direct), ("operator", op), ("operator", op),
                             ("direct", direct)):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                times[kind].append((time.perf_counter() - t0) / 200 * 1e6)
                torch.cuda.synchronize()
        out[name] = {k: float(np.mean(v)) for k, v in times.items()}
        out[name]["added_us"] = out[name]["operator"] - out[name]["direct"]
    return out


def export_phase(model, dev, scenes) -> dict:
    """Phase 13: the serving artifact, ``--mode trace`` and a profiled
    evaluation, on the card."""
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.main import main as cli
    from vlsat_tpu_torch.serving import BatchedServer, bench_server
    from vlsat_tpu_torch.serving_export import export_serving_artifact, load_serving_artifact
    from vlsat_tpu_torch.train.step import make_eval_step
    from vlsat_tpu_torch.utils import profiling

    shutil.rmtree(EXPORT_WORK, ignore_errors=True)
    EXPORT_WORK.mkdir(parents=True)
    art = EXPORT_WORK / "artifact"
    out: dict = {}
    # 1. export the flagship's 3D-only forward (fused PointNet: both kernels
    # are operators inside the programs); tracing launches no kernel.  The
    # counters stay unreset from here to the read after step 5: they count
    # the path's own launches (live step, reload, servers, trace, profiled
    # evaluation), and the dispatch timing runs after that read
    reset_launches()
    t0 = time.monotonic()
    manifest = export_serving_artifact(model, str(art), buckets=EXPORT_BUCKETS,
                                       max_batch=BATCH, num_points=128, device=dev)
    out["export_s"] = {b: e["export_s"] for b, e in manifest["buckets"].items()}
    out["export_wall_s"] = time.monotonic() - t0
    if any(read_launches().values()):
        fail(f"export: tracing launched kernels: {read_launches()}")
    out["artifact_bytes"] = sum(f.stat().st_size for f in art.iterdir())
    out["pt2_bytes"] = {f.name: f.stat().st_size for f in art.glob("*.pt2")}

    # 2. reload in a process without the model source; outputs and launches
    # against the live eval step
    batches = [serving_batch(scenes, b) for b in EXPORT_BUCKETS]
    torch.save([vars(b) for b in batches], EXPORT_WORK / "inputs.pt")
    live_step = make_eval_step(model, branch_3d_only=True, device=dev)
    live, live_launches = [], []
    for b in batches:
        before = read_launches()
        live.append({k: v.cpu() for k, v in live_step(model.state_dict(), b).items()})
        torch.cuda.synchronize()
        now = read_launches()
        live_launches.append([now["segment_max"] - before["segment_max"],
                              now["pointnet_fused"] - before["pointnet_fused"]])
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", RELOAD, str(art), str(EXPORT_WORK / "inputs.pt"),
                           str(EXPORT_WORK / "outputs.pt")], capture_output=True, text=True,
                          timeout=600, cwd=str(Path(__file__).resolve().parent),
                          env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
    if proc.returncode != 0:
        fail(f"export: the reload process failed ({proc.returncode}): {proc.stderr[-4000:]}")
    got = torch.load(EXPORT_WORK / "outputs.pt")
    out["reload_process_s"] = time.monotonic() - t0
    out["load_s_fresh_process"] = got["load_s"]
    if got["models"]:
        fail(f"export: the reload process imported {got['models']}")
    if got["launches"] != live_launches or any(sm <= 0 or pn <= 0 for sm, pn in live_launches):
        fail(f"export: artifact launches {got['launches']} != live {live_launches} "
             "(segment-max, PointNet a batch)")
    diffs = {}
    for bucket, g, w in zip(EXPORT_BUCKETS, got["outs"], live):
        for key in ("obj_logits_3d", "rel_cls_3d"):
            diffs[f"{key}@{bucket}"] = (g[key] - w[key]).abs().max().item()
            if not torch.allclose(g[key], w[key], rtol=1e-6, atol=1e-6):
                fail(f"export: the artifact's {key} at bucket {bucket} differs from the live "
                     f"step: max abs {diffs[f'{key}@{bucket}']}")
    out["artifact_vs_live"] = {"max_abs_diff": diffs, "launches_per_batch": live_launches}
    log(f"export: buckets {EXPORT_BUCKETS} exported in {out['export_s']} s, "
        f"{out['artifact_bytes']} bytes; reloaded without the model source in "
        f"{got['load_s']:.2f} s; outputs within 1e-6 of the live step (max abs "
        f"{max(diffs.values()):.3g}), launches {got['launches']} equal to the live step's")

    # 3. serve phase 5's scenes through BatchedServer on the artifact and on
    # the live model, in turns
    t0 = time.monotonic()
    loaded = load_serving_artifact(str(art), device=dev)
    out["load_s"] = time.monotonic() - t0
    kw = dict(max_batch=BATCH, deadline_ms=5.0, buckets=EXPORT_BUCKETS)
    rates = {"live": [], "artifact": []}
    for kind in ("live", "artifact", "artifact", "live"):
        server = (BatchedServer(model, device=dev, **kw) if kind == "live"
                  else BatchedServer(eval_step=loaded, **kw))
        with server:
            for sc in scenes[:BATCH]:  # warm-up: first-call allocations per bucket
                server.predict(sc, timeout=300)
            res = bench_server(server, scenes, duration_s=3.0, clients=2 * BATCH)
            torch.cuda.synchronize()
        rates[kind].append(res["scenes_per_sec"])
    out["serving_scenes_per_sec"] = rates
    log(f"export: served {rates['artifact']} scenes/s on the artifact, {rates['live']} on the "
        "live model (turns live, artifact, artifact, live)")

    # 4. main --mode trace on phase 11's JSON
    t0 = time.monotonic()
    report = cli(["--config", str(RUN_WORK / "cfg.json"), "--mode", "trace"])
    out["trace_command_s"] = time.monotonic() - t0
    if not (report["checked_small"] and report["checked_large"]):
        fail(f"export: main --mode trace reported {report}")
    traced = Path(report["program_small"]).parent
    out["trace_files"] = {f.name: f.stat().st_size for f in sorted(traced.iterdir())}

    # 5. one evaluation under utils.profiling.trace (a warm-up, then the
    # profiled one) in a fresh process: the Chrome trace holds one event of
    # each kernel a counted launch
    batches = labelled_splits(SEED + 2, large=())["val"][:3]
    torch.save({"state": {k: v.cpu() for k, v in model.state_dict().items()},
                "batches": [vars(b) for b in batches]}, EXPORT_WORK / "profile_inputs.pt")
    proc = subprocess.run([sys.executable, "-c", PROFILE, str(EXPORT_WORK / "profile_inputs.pt"),
                           str(EXPORT_WORK / "profile")], capture_output=True, text=True,
                          timeout=600, cwd=str(Path(__file__).resolve().parent),
                          env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
    if proc.returncode != 0:
        fail(f"export: the profiling process failed ({proc.returncode}): {proc.stderr[-4000:]}")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    fresh = trace_counts(prof["path"])
    found = [fresh["segment_max"], fresh["pointnet_fused"]]
    if found != prof["profiled"] or not all(found):
        fail(f"export: the profiled evaluation's trace holds {found} kernel events for "
             f"{prof['profiled']} counted launches (segment-max, PointNet)")
    # the same evaluation profiled in this process, recorded, not gated: its
    # trace may lack the session's first kernel records
    step = make_eval_step(model, device=dev)
    evaluate(step, model.state_dict(), batches, verbose=False)
    before = read_launches()
    with profiling.trace(str(EXPORT_WORK / "profile_here")) as path:
        evaluate(step, model.state_dict(), batches, verbose=False)
        torch.cuda.synchronize()
    here = trace_counts(path)
    here["launches_counted"] = [read_launches()[k] - before[k]
                                for k in ("segment_max", "pointnet_fused")]
    out["profile"] = {"trace_bytes": os.path.getsize(prof["path"]), **fresh,
                      "launches_counted": prof["profiled"], "in_this_process": here}
    out["launches"] = read_launches()
    for sub in (np.sum(got["launches"], 0).tolist(), prof["total"]):
        out["launches"]["segment_max"] += sub[0]
        out["launches"]["pointnet_fused"] += sub[1]
    # 6. the host cost of the operator dispatch, after the read: its
    # launches are not the path's
    out["dispatch_us"] = dispatch_us(dev)
    log(f"export: main --mode trace {out['trace_command_s']:.1f} s "
        f"({sorted(out['trace_files'])}); profiled evaluation in a fresh process: {found} kernel "
        f"events for {prof['profiled']} counted launches (segment-max, PointNet), in this "
        f"process {[here['segment_max'], here['pointnet_fused']]} for "
        f"{here['launches_counted']} ({here['kernel_records']} kernel records for "
        f"{here['launch_calls']} launch calls); "
        f"operator dispatch {out['dispatch_us']}")
    shutil.rmtree(EXPORT_WORK, ignore_errors=True)  # phase 14 still reads RUN_WORK
    return out


DP_WORK = WORK.parent / "data_parallel"
DP_TIMED_STEPS = 12        # timed train steps of each configuration
DP_TIMEOUT_S = 300         # the groups' collective timeout


class SGD:
    """Plain SGD in the spec interface of ``train.optim.make_optimizer``'s
    result (the sharding gate's optimizer, tests/test_production_shape_sharding.py)."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, model):
        opt = torch.optim.SGD(model.parameters(), lr=self.lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 1.0)

    update = staticmethod(lambda optimizer, scheduler: (optimizer.step(), scheduler.step()))


class ListScenes:
    """``data.packed.pack_scenes``'s view of in-memory scene dicts."""

    multi_rel = True

    def __init__(self, scenes: list, feat_dim: int = 512, num_points: int = 128):
        from types import SimpleNamespace

        self._scenes = scenes
        self.feat_dim, self.num_points = feat_dim, num_points
        self.index = SimpleNamespace(scenes=[SimpleNamespace(scan_id=f"scene{i:04d}")
                                             for i in range(len(scenes))])
        self.w_cls_obj, self.w_cls_rel = np.ones(160), np.ones(26)

    def __len__(self) -> int:
        return len(self._scenes)

    def prepare(self, i: int, rng) -> dict:
        return self._scenes[i]


def dp_work(inp: dict, world, dev) -> dict:
    """Phase 14's work on ``dev``, in one rank of ``world`` or, with
    ``world=None``, without a group: one SGD step, three AdamW steps and
    ``DP_TIMED_STEPS`` timed ones at B=8 (dropout on), then the sharded
    streaming and resident evaluations at B=32 (rank lists under
    ``inp["work"]``), each timed pass with the launch counters at 0 just
    before it."""
    from vlsat_tpu_torch import parallel
    from vlsat_tpu_torch.data.packed import PackedScenes
    from vlsat_tpu_torch.data.resident import (ResidentGroupedEval, ResidentScenes,
                                               ResidentShardedEval)
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_eval_step, make_train_step

    cfg = MMGNetConfig(fused_pointnet=True)
    tag = "none" if world is None else f"dp{world.size}"
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    tb = inp["train"]
    out: dict = {"tag": tag, "launches": {}}
    reset_launches()
    model = build_mmgnet(cfg, device=dev, seed=SEED + 14)
    sgd = SGD(1e-2)
    state = create_train_state(model, sgd)
    _, aux = make_train_step(model, sgd, device=dev, world=world)(state, tb[0], 0)
    out["sgd_loss"] = aux["loss"].item()
    out["sgd_state"] = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    model = build_mmgnet(cfg, device=dev, seed=SEED + 14)
    spec = make_optimizer(lr=1e-4, max_iteration=1000)
    state = create_train_state(model, spec)
    step = make_train_step(model, spec, device=dev, world=world)
    out["adamw_losses"] = [step(state, b, i)[1]["loss"].item() for i, b in enumerate(tb[1:4])]
    timed = tb[4:4 + DP_TIMED_STEPS]
    sync()
    t0 = time.monotonic()
    for i, b in enumerate(timed):
        _, aux = step(state, b, 10 + i)
    aux["loss"].item()
    wall = time.monotonic() - t0
    out["train"] = {"steps": len(timed), "step_wall_ms": wall * 1e3 / len(timed),
                    "scenes_per_sec": sum(b.num_scenes for b in timed) / wall}
    out["launches"]["train"] = read_launches()
    out["param_checksum"] = float(sum(p.detach().double().sum().item()
                                      for p in model.parameters()))
    del model, state, step

    model = build_mmgnet(cfg, device=dev, seed=SEED + 14)
    estep = make_eval_step(model, device=dev)
    sd = model.state_dict()
    kw = dict(num_rel_classes=26, verbose=False, scene_recall=True,
              train_triplet_vocab=inp["vocab"])
    packed = PackedScenes(inp["pack"])
    loaders = {
        "stream": lambda: (inp["eval"] if world is None
                           else parallel.shard_eval_batches(inp["eval"], world)),
        "resident": lambda: (
            ResidentGroupedEval(ResidentScenes(packed, device=dev), BATCH, group=EVAL_GROUP)
            if world is None else ResidentShardedEval(packed, world, BATCH, group=EVAL_GROUP)),
    }
    for name, make in loaders.items():
        loader = make()
        evaluate(estep, sd, loader, **kw)  # warm-up
        sync()
        reset_launches()
        t0 = time.monotonic()
        metrics = evaluate(estep, sd, loader, save_dir=str(Path(inp["work"]) / f"{tag}_{name}"),
                           **kw)
        sync()
        wall = time.monotonic() - t0
        out["launches"][name] = read_launches()
        out[f"eval_{name}"] = {"wall_s": wall, "scenes_per_sec": inp["eval_scenes"] / wall,
                               "metrics": metrics}
    return out


def dp_rank(path: str) -> dict:
    """``dp_work`` in one rank of the group ``parallel.spawn_ranks`` made;
    returns rank 0's result with every rank's launches and checksum."""
    import torch.distributed as dist

    from vlsat_tpu_torch import parallel

    w = parallel.world()
    res = dp_work(torch.load(path, weights_only=False), w, w.device)
    ranks = [None] * w.size
    dist.all_gather_object(ranks, {"launches": res["launches"],
                                   "param_checksum": res["param_checksum"],
                                   "adamw_losses": res["adamw_losses"]}, group=w.host_group)
    res["ranks"] = ranks
    res["world"] = {"size": w.size, "backend": w.backend, "device": str(w.device)}
    return res


def run_group(cmd: list, timeout: float, cwd) -> str:
    """Run ``cmd`` in a session of its own (a launcher and its workers);
    on a timeout or a non-zero exit kill the whole session and fail."""
    import signal

    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"data parallel: {' '.join(cmd[:6])} ... did not finish within {timeout} s")
    if proc.returncode:
        fail(f"data parallel: {' '.join(cmd[:6])} ... exited {proc.returncode}: {text[-3000:]}")
    return text


def dp_cli(here: Path) -> dict:
    """``main --mode train --data-parallel`` for one epoch on phase 11's
    pack and JSON with two ranks under torchrun (gloo on the one card), then
    ``--mode eval``; a one-process run of the same JSON as the reference."""
    from vlsat_tpu_torch.main import main as cli

    base = json.loads((RUN_WORK / "cfg.json").read_text())
    # the streamed per-step path: the resident split is single-rank, and a
    # streamed K-stack of the 8/12-node pack would mix buckets; every step's
    # loss logged (AdamW turns fp32 reassociation noise into lr-sized steps,
    # so the runs drift apart after the first few)
    base.update(MAX_EPOCHES=1, TRAIN_RESIDENT=False, TRAIN_MICROSTEPS=1, LOG_INTERVAL=1)
    paths = {}
    for name in ("one", "dp"):
        paths[name] = DP_WORK / f"cli_{name}.json"
        paths[name].write_text(json.dumps({**base, "PATH": str(DP_WORK / f"cli_{name}")}))
    out: dict = {}
    t0 = time.monotonic()
    cli(["--config", str(paths["one"]), "--mode", "train"])
    out["one_process_train_s"] = time.monotonic() - t0
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "vlsat_tpu_torch.main", "--config", str(paths["dp"]), "--data-parallel"]
    t0 = time.monotonic()
    run_group(run + ["--mode", "train"], 900, here)
    out["dp_train_s"] = time.monotonic() - t0
    dp = DP_WORK / "cli_dp"
    result = dp / "results" / "Mmgnet" / "default" / "result.txt"
    closing = result.read_text()
    t0 = time.monotonic()
    run_group(run + ["--mode", "eval"], 600, here)
    out["dp_eval_s"] = time.monotonic() - t0
    if result.read_text() != closing:
        fail("data parallel, CLI: --mode eval metrics differ from the closing validation's")
    counts = {n: sum(n in d or n in f for _, d, f in os.walk(dp))
              for n in ("checkpoints", "result.txt", "epoch_stats.jsonl", "events.jsonl")}
    if any(v != 1 for v in counts.values()):
        fail(f"data parallel, CLI: want one of each written by rank 0, found {counts}")
    losses = {}
    for name in ("one", "dp"):
        with open(DP_WORK / f"cli_{name}" / "logs" / "Mmgnet" / "default" / "events.jsonl") as f:
            losses[name] = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
        with open(DP_WORK / f"cli_{name}" / "Mmgnet" / "default" / "epoch_stats.jsonl") as f:
            out[f"{name}_epoch"] = json.loads(f.readline())
    n = min(3, len(losses["one"]))
    if n == 0 or len(losses["dp"]) != len(losses["one"]) or not np.allclose(
            losses["dp"][:n], losses["one"][:n], rtol=1e-5, atol=0):
        fail(f"data parallel, CLI: first logged losses {losses['dp'][:n]} against one "
             f"process's {losses['one'][:n]} (rtol 1e-5)")
    out["first_logged_losses"] = {k: v[:n] for k, v in losses.items()}
    rel = np.abs(np.subtract(losses["dp"], losses["one"])) / np.abs(losses["one"])
    out["loss_rel_diff_by_step"] = {"steps": len(rel), "max_first_10": float(rel[:10].max()),
                                    "max": float(rel.max()), "median": float(np.median(rel))}
    out["files"] = counts
    out["metrics"] = len([l for l in closing.splitlines() if l.startswith("Eval: ")])
    return out


def data_parallel(dev: torch.device) -> dict:
    """Phase 14: data parallelism on the one card."""
    from vlsat_tpu_torch import parallel
    from vlsat_tpu_torch.data.packed import PackedScenes, pack_scenes
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet

    here = Path(__file__).resolve().parent
    shutil.rmtree(DP_WORK, ignore_errors=True)
    DP_WORK.mkdir(parents=True)
    t0 = time.monotonic()
    val = split_scenes(SEED + 2)["val"]  # phase 8's split
    pack_scenes(ListScenes(val), str(DP_WORK / "pack"), seed=SEED)
    evb = labelled_splits(SEED + 2)["val"]
    tb = labelled_splits(SEED + 3, batch=TRAIN_BATCH, large=(), with_text=True)["val"]
    tb = [b for b in tb if b.num_scenes == TRAIN_BATCH][:4 + DP_TIMED_STEPS]
    inp = {"train": tb, "eval": evb, "eval_scenes": sum(b.num_scenes for b in evb),
           "vocab": triplet_vocab(evb), "pack": str(DP_WORK / "pack"), "work": str(DP_WORK)}
    torch.save(inp, DP_WORK / "inputs.pt")
    rows = eval_rows(PackedScenes(str(DP_WORK / "pack")), BATCH, EVAL_GROUP)
    log(f"data parallel: {len(evb)} eval batches of phase 8's split (B={BATCH}, "
        f"{inp['eval_scenes']} scenes, {rows} grouped resident rows), {len(tb)} train batches "
        f"(B={TRAIN_BATCH}), pack written, in {time.monotonic() - t0:.1f} s")

    runs = {"none": dp_work(inp, None, dev)}
    for n in (1, 2):
        t0 = time.monotonic()
        runs[f"dp{n}"] = parallel.spawn_ranks(dp_rank, n, str(DP_WORK / "inputs.pt"),
                                              device=dev.type, timeout_s=DP_TIMEOUT_S)
        runs[f"dp{n}"]["spawn_s"] = time.monotonic() - t0
        w = runs[f"dp{n}"]["world"]
        # NCCL needs a card a rank; two ranks on one card take gloo
        want = {"size": n, "backend": "nccl" if n == 1 and dev.type == "cuda" else "gloo",
                "device": str(torch.device(dev.type, 0)) if dev.type == "cuda" else "cpu"}
        if w != want:
            fail(f"data parallel: dp={n} formed {w}; want {want}")
    ref = runs["none"]
    initial = {k: v.detach().cpu().numpy()
               for k, v in build_mmgnet(MMGNetConfig(fused_pointnet=True), device="cpu",
                                        seed=SEED + 14).state_dict().items()}
    checks: dict = {}
    for tag in ("dp1", "dp2"):
        r = runs[tag]
        if not np.isclose(r["sgd_loss"], ref["sgd_loss"], rtol=1e-5, atol=0):
            fail(f"data parallel, {tag}: SGD step loss {r['sgd_loss']} against {ref['sgd_loss']}")
        if not np.allclose(r["adamw_losses"], ref["adamw_losses"], rtol=1e-5, atol=0):
            fail(f"data parallel, {tag}: AdamW losses {r['adamw_losses']} against "
                 f"{ref['adamw_losses']} (rtol 1e-5)")
        worst = 0.0
        for k, want in ref["sgd_state"].items():
            diff = float(np.abs(r["sgd_state"][k] - want).max()) if want.size else 0.0
            upd = float(np.abs(want - initial[k]).max()) if want.size else 0.0
            if diff > max(5e-5, 1e-2 * upd):
                fail(f"data parallel, {tag}: leaf {k} off by {diff} after one SGD step "
                     f"(update {upd}; gate max(5e-5, 1e-2 x update))")
            worst = max(worst, diff / max(5e-5, 1e-2 * upd))
        per_rank = r["ranks"]
        if len({p["param_checksum"] for p in per_rank}) != 1:
            fail(f"data parallel, {tag}: the ranks' weights differ: {per_rank}")
        for i, p in enumerate(per_rank):
            lt = p["launches"]["train"]
            if any(lt.values()):
                fail(f"data parallel, {tag} rank {i}: train steps launched {lt}")
            for name, batches in (("stream", len(evb)), ("resident", rows)):
                got = p["launches"][name]
                if got["segment_max"] != 4 * batches or got["pointnet_fused"] != batches:
                    fail(f"data parallel, {tag} rank {i}, {name} evaluation: launches {got} "
                         f"for {batches} batches (want 4 segment-max and 1 PointNet each)")
        mism = {}
        for name in ("stream", "resident"):
            got = rank_lists(DP_WORK / f"{tag}_{name}")
            want = rank_lists(DP_WORK / f"none_{name}")
            m = {k: int((got[k] != v).sum()) if got[k].shape == v.shape else -1
                 for k, v in want.items()}
            total = sum(v.size for v in want.values())
            if min(m.values()) < 0 or sum(m.values()) > 1e-3 * total:
                fail(f"data parallel, {tag} {name}: rank-list mismatches {m} of {total}")
            mism[name] = {"mismatches": m, "ranks": total}
        checks[tag] = {"sgd_loss": r["sgd_loss"], "adamw_losses": r["adamw_losses"],
                       "sgd_worst_gate_fraction": worst, "rank_lists": mism,
                       "launches_per_rank": [p["launches"] for p in per_rank]}
        log(f"data parallel, {tag} ({r['world']['backend']}): SGD loss {r['sgd_loss']:.9g} "
            f"against {ref['sgd_loss']:.9g}, AdamW losses {r['adamw_losses']} against "
            f"{ref['adamw_losses']}; every leaf at the SGD gate (worst {worst:.3f} of it); "
            f"rank-list mismatches {mism}; launches per rank {checks[tag]['launches_per_rank']}")
    out = {"checks": checks, "ref_sgd_loss": ref["sgd_loss"],
           "ref_adamw_losses": ref["adamw_losses"],
           "throughput_collective_overhead_on_one_card": {
               tag: {"trained_scenes_per_sec": r["train"]["scenes_per_sec"],
                     "step_wall_ms": r["train"]["step_wall_ms"],
                     "evaluated_scenes_per_sec_stream": r["eval_stream"]["scenes_per_sec"],
                     "evaluated_scenes_per_sec_resident": r["eval_resident"]["scenes_per_sec"],
                     "spawn_s": r.get("spawn_s")}
               for tag, r in runs.items()}}
    log("data parallel, collective overhead on one card (not scaling): " + json.dumps(
        out["throughput_collective_overhead_on_one_card"]))
    out["cli"] = dp_cli(here)
    log(f"data parallel, CLI: torchrun 2 ranks, train {out['cli']['dp_train_s']:.1f} s, eval "
        f"{out['cli']['dp_eval_s']:.1f} s (one process: {out['cli']['one_process_train_s']:.1f} "
        f"s); closing validation equal to --mode eval on {out['cli']['metrics']} metrics; "
        f"first losses {out['cli']['first_logged_losses']}; files {out['cli']['files']}")
    out["launches"] = {k: sum(p["launches"][name][k] for tag in ("dp1", "dp2")
                              for p in runs[tag]["ranks"] for name in ("stream", "resident"))
                       for k in ("segment_max", "pointnet_fused", "pointnet_fused_v2")}
    shutil.rmtree(DP_WORK, ignore_errors=True)
    shutil.rmtree(RUN_WORK, ignore_errors=True)
    shutil.rmtree(WORK, ignore_errors=True)
    return out


OFFLINE_WORK = WORK.parent / "offline"
OFFLINE_SCANS = 16         # data-feed scans of the pipeline run
OFFLINE_FRAMES = 60        # depth and colour frames of the depth and projection checks
DEPTH_HW = (172, 224)      # a 3RScan depth map (rows, cols)
DEPTH_STRIDE = 8
COLOR_HW = (540, 960)      # a 3RScan colour frame
PIPE_FRAMES = 6            # colour frames a scan in the pipeline run
ADAPTER_EPOCHS = 4         # of the trainer's default 20: 12 took 34.0 s on the card and
                           # 41.5 s on the CPU (NVIDIA H100 80GB HBM3, 700.00 W)
DEPTH_REPS = 5             # timed passes over the depth frames (the median is kept)
ADAPTER_BATCH = 32
ADAPTER_GATE_STEPS = 50    # first step losses held against the CPU run


def look_at(eye, target) -> np.ndarray:
    """camera -> world pose of a camera at ``eye`` looking at ``target``
    (x right, y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    pose[:3, 3] = eye
    return pose


def camera_rig(points: np.ndarray, n: int, radius: float = 12.0) -> list:
    """``n`` camera -> world poses on a circle around the scan, looking at
    its centre, at slightly varying heights."""
    c = points.mean(0)
    return [look_at(c + [radius * np.cos(a), radius * np.sin(a), 1.5 + 0.5 * np.sin(3 * a)], c)
            for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]


def color_intrinsic() -> np.ndarray:
    h, w = COLOR_HW
    return np.asarray([[756.0, 0, w / 2, 0], [0, 756.0, h / 2, 0], [0, 0, 1, 0]], np.float32)


def render_depth(points: np.ndarray, pose: np.ndarray, k: np.ndarray) -> np.ndarray:
    """A z-buffered depth map of ``points`` at DEPTH_HW (0 where nothing
    projects), as a depth sensor would see the labelled mesh."""
    h, w = DEPTH_HW
    w2c = np.linalg.inv(pose)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    cam = cam[cam[:, 2] > 0.1]
    uv = cam @ k.astype(np.float64).T
    u = np.floor(uv[:, 0] / uv[:, 2]).astype(np.int64)
    v = np.floor(uv[:, 1] / uv[:, 2]).astype(np.int64)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.full((h, w), np.inf)
    np.minimum.at(depth, (v[ok], u[ok]), cam[ok, 2])
    depth[np.isinf(depth)] = 0
    return depth.astype(np.float32)


def near_ties(queries: torch.Tensor, points: torch.Tensor, rel: float = 1e-6,
              chunk: int = 2048) -> torch.Tensor:
    """Queries whose two nearest squared distances differ by under ``rel``
    relative (where two devices may pick either point)."""
    out = []
    for i in range(0, len(queries), chunk):
        diff = queries[i:i + chunk, None, :] - points[None, :, :]
        d2 = (diff * diff).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        out.append((two[:, 1] - two[:, 0]) <= rel * two[:, 1])
    return torch.cat(out)


def offline_scans() -> tuple:
    """(root, scans_root, multi_view_root) of OFFLINE_SCANS data-feed scans
    laid out as ``<multi_view_root>/data/3RScan/<scan>``."""
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split, validation_scene_stats

    nodes, rels = validation_scene_stats(OFFLINE_SCANS, seed=SEED + 15)
    root, scans, _ = make_synthetic_split(
        str(OFFLINE_WORK / "split"), num_scans=OFFLINE_SCANS, node_counts=nodes,
        rel_counts=rels, vertices_per_inst=VERTS_PER_INST, seed=SEED + 15, write_ply=True,
        background_verts=BG_VERTS)
    mv_root = OFFLINE_WORK / "mv"
    (mv_root / "data").mkdir(parents=True)
    shutil.move(scans, mv_root / "data" / "3RScan")
    return root, str(mv_root / "data" / "3RScan"), str(mv_root)


def offline_depth(dev, pts: np.ndarray, inst: np.ndarray) -> dict:
    """``visible_instances_per_frame`` on OFFLINE_FRAMES depth maps, the card
    against the CPU."""
    from vlsat_tpu_torch.preprocess.depth import (backproject_depth, nearest_instance,
                                                  visible_instances_per_frame)

    h, w = DEPTH_HW
    k = np.asarray([[177.0, 0, w / 2], [0, 177.0, h / 2], [0, 0, 1]], np.float32)
    poses = [p.astype(np.float32) for p in camera_rig(pts, OFFLINE_FRAMES)]
    depths = [render_depth(pts, p, k) for p in poses]
    visible_instances_per_frame(depths[:2], k, poses[:2], pts, inst, device=dev)  # warm-up
    walls = []
    for _ in range(DEPTH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vis = visible_instances_per_frame(depths, k, poses, pts, inst, stride=DEPTH_STRIDE,
                                          device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    secs = float(np.median(walls))
    vis_cpu = visible_instances_per_frame(depths, k, poses, pts, inst, stride=DEPTH_STRIDE,
                                          device="cpu")
    # the back-projection at the parity gate, and the assignments of every query
    k_sub = k.copy()
    k_sub[:2] /= DEPTH_STRIDE
    queries, worst = [], 0.0
    for d, p in zip(depths, poses):
        ds = np.ascontiguousarray(d[::DEPTH_STRIDE, ::DEPTH_STRIDE])
        args = [torch.from_numpy(a) for a in (ds, k_sub, p)]
        got = backproject_depth(*[a.to(dev) for a in args]).cpu()
        want = backproject_depth(*args)
        if not torch.allclose(got, want, rtol=1e-3, atol=1e-4):
            fail(f"offline, depth: backproject_depth differs from the CPU run by "
                 f"{(got - want).abs().max().item()}")
        worst = max(worst, (got - want).abs().max().item())
        queries.append(got[torch.from_numpy(ds.reshape(-1) > 0)])
    q = torch.cat(queries).numpy()
    got = nearest_instance(q, pts, inst, device=dev)
    want = nearest_instance(q, pts, inst, device="cpu")
    ties = near_ties(torch.from_numpy(q).to(dev), torch.from_numpy(pts).to(dev)).cpu().numpy()
    bad = (got != want) & ~ties
    if bad.any():
        fail(f"offline, depth: {int(bad.sum())} of {len(q)} nearest-instance assignments "
             f"differ from the CPU run away from a near tie")
    if (got != want).sum() == 0 and vis != vis_cpu:
        fail("offline, depth: the visible-instance lists differ from the CPU run")
    if not any(vis.values()):
        fail("offline, depth: no frame saw an instance")
    return {"frames": len(depths), "depth_hw": list(DEPTH_HW), "stride": DEPTH_STRIDE,
            "labelled_points": int(len(pts)), "queries": int(len(q)),
            "frames_per_sec": len(depths) / secs, "wall_s": secs,
            "frames_per_sec_range": [len(depths) / max(walls), len(depths) / min(walls)],
            "backproject_max_abs_diff": worst,
            "assignments_differing": int((got != want).sum()), "near_tie_queries": int(ties.sum()),
            "visible_pairs": int(sum(map(len, vis.values()))), "lists_equal": vis == vis_cpu}


def offline_projection(dev, pts: np.ndarray, inst: np.ndarray, names: dict) -> dict:
    """``process_scene`` over OFFLINE_FRAMES colour frames for every instance
    of the scan, the card against the CPU."""
    from vlsat_tpu_torch.projection import MultiViewFeatureExtractor, project_points
    from vlsat_tpu_torch.tools.run_full_pipeline import hash_image_encoder

    h, w = COLOR_HW
    rng = np.random.RandomState(SEED + 16)
    images = [rng.randint(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(OFFLINE_FRAMES)]
    extr = np.stack([np.linalg.inv(p) for p in camera_rig(pts, OFFLINE_FRAMES)]).astype(np.float32)
    intr = color_intrinsic()
    # project_points per instance: pix at rtol 1e-5 / atol 1e-4; visibility and
    # crop boxes equal away from a border and from an integer
    e_c, i_c = torch.from_numpy(extr).to(dev), torch.from_numpy(intr).to(dev)
    excluded_points = excluded_boxes = boxes = 0
    unsure = set()
    for iid in names:
        p = torch.from_numpy(pts[inst == iid])
        pix, vis = (t.cpu() for t in project_points(p.to(dev), e_c, i_c, w, h))
        pix_h, vis_h = project_points(p, torch.from_numpy(extr), torch.from_numpy(intr), w, h)
        if not torch.allclose(pix, pix_h, rtol=1e-5, atol=1e-4, equal_nan=True):
            fail(f"offline, projection: instance {iid} pix differ from the CPU run by "
                 f"{(pix - pix_h).abs().nan_to_num().max().item()}")
        u, v = pix_h[..., 0], pix_h[..., 1]
        border = ((u.abs() < 1e-3) | ((u - w).abs() < 1e-3) | (v.abs() < 1e-3)
                  | ((v - h).abs() < 1e-3))
        if ((vis != vis_h) & ~border).any():
            fail(f"offline, projection: instance {iid} visibility differs off the borders")
        excluded_points += int(border.sum())
        for f in range(len(extr)):
            if not (vis[f].any() or vis_h[f].any()):
                continue
            boxes += 1
            a, b = pix[f][vis[f]], pix_h[f][vis_h[f]]
            ext = torch.stack([b.min(0).values, b.max(0).values]) if len(b) else b
            near_int = (ext - ext.round()).abs() < 1e-3
            if len(a) == 0 or len(b) == 0 or (vis[f] != vis_h[f]).any() or near_int.any():
                excluded_boxes += 1
                unsure.add(iid)
                continue
            if [int(x) for x in torch.cat([a.min(0).values, a.max(0).values])] != \
                    [int(x) for x in torch.cat([b.min(0).values, b.max(0).values])]:
                fail(f"offline, projection: instance {iid} frame {f} crop box differs")
    ex = MultiViewFeatureExtractor(hash_image_encoder, device=dev)
    ex.process_scene(pts, inst, dict(list(names.items())[:1]), images, extr, intr, {}, w, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = ex.process_scene(pts, inst, names, images, extr, intr, {}, w, h)
    secs = time.perf_counter() - t0
    cpu = MultiViewFeatureExtractor(hash_image_encoder, device="cpu").process_scene(
        pts, inst, names, images, extr, intr, {}, w, h)
    if sorted(feats) != sorted(cpu) or len(feats) != len(names):
        fail(f"offline, projection: instances {sorted(feats)} against the CPU's {sorted(cpu)}")
    differing = [i for i in feats if not np.array_equal(feats[i], cpu[i])]
    if set(differing) - unsure:
        fail(f"offline, projection: features of instances {differing} differ from the CPU's")
    return {"frames": len(images), "color_hw": list(COLOR_HW), "instances": len(feats),
            "instances_per_sec": len(feats) / secs, "wall_s": secs,
            "boxes_checked": boxes, "excluded_points_near_border": excluded_points,
            "excluded_boxes_near_integer": excluded_boxes, "features_differing": len(differing)}


def offline_colour(pts: np.ndarray, inst: np.ndarray) -> dict:
    """The OBJ colour transfer of the scan's label mesh from a seeded
    texture: ``uv_to_color`` on the decoded texture array, and ``load_rgb``'s
    textured-OBJ route reading the same texture from a PNG file (colours
    equal)."""
    from vlsat_tpu_torch.data.obj import (LABEL_FILE_NAME, LABEL_FILE_NAME_RAW, MTL_NAME,
                                          OBJ_NAME, load_rgb, uv_to_color)
    from vlsat_tpu_torch.data.ply import write_ply_vertices

    rng = np.random.RandomState(SEED + 17)
    tex = rng.randint(0, 255, (1024, 1024, 3), dtype=np.uint8)
    uv = rng.rand(len(pts), 2).astype(np.float32)  # an OBJ's vt lines parse to float32
    t0 = time.perf_counter()
    colors = uv_to_color(uv, tex)
    out = {"vertices": int(len(pts)), "uv_to_color_s": time.perf_counter() - t0}
    from PIL import Image

    d = OFFLINE_WORK / "textured"
    d.mkdir(parents=True)
    Image.fromarray(tex).save(d / "texture.png")
    (d / MTL_NAME).write_text("newmtl m\nmap_Kd texture.png\n")
    lines = ["mtllib " + MTL_NAME]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in pts.astype(np.float64).tolist()]
    lines += [f"vt {a!r} {b!r}" for a, b in uv.astype(np.float64).tolist()]
    lines += [f"f {i}/{i} {i + 1}/{i + 1} {i + 2}/{i + 2}" for i in range(1, len(pts) - 1)]
    (d / OBJ_NAME).write_text("\n".join(lines) + "\n")
    write_ply_vertices(str(d / LABEL_FILE_NAME_RAW), pts, instances=inst)
    write_ply_vertices(str(d / LABEL_FILE_NAME), pts + 1.0, instances=inst)
    t0 = time.perf_counter()
    mesh = load_rgb(str(d), max_dist=1e-5)
    out["load_rgb_s"] = time.perf_counter() - t0
    if not np.array_equal(mesh.colors, colors):
        fail("offline, colour: load_rgb's colours differ from uv_to_color on the array")
    return out


def adapter_inputs() -> dict:
    """The adapter job's shape: 512-d features, the 160-class table, the
    validation split's instances (relationships_validation.json) and the
    train split's count scaled by its scans; features drawn from a seed
    around one centre a class."""
    from vlsat_tpu_torch.clipsem import HashTextEncoder, build_label_tables
    from vlsat_tpu_torch.data.assets import read_classes, read_txt_lines

    assets = Path(__file__).resolve().parent / "assets" / "3dssg"
    classes = read_classes(str(assets))
    table, _ = build_label_tables(classes, read_txt_lines(str(assets / "relations.txt")),
                                  HashTextEncoder())
    with open(assets / "relationships_validation.json") as f:
        val_names = [n for s in json.load(f)["scans"] for n in s["objects"].values()]
    val_labels = np.asarray([classes.index(n) for n in val_names])
    scale = (len(read_txt_lines(str(assets / "train_scans.txt")))
             / len(read_txt_lines(str(assets / "validation_scans.txt"))))
    rng = np.random.RandomState(SEED + 18)
    train_labels = rng.choice(val_labels, int(round(len(val_labels) * scale)))
    centers = rng.randn(len(classes), 512).astype(np.float32)

    def draw(labels):
        x = centers[labels] + rng.randn(len(labels), 512).astype(np.float32) * 1.2
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    init = {name: {"kernel": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32),
                   "bias": np.zeros(o, np.float32)}
            for name, i, o in (("fc1", 512, 256), ("fc2", 256, 512))}
    return {"train": (draw(train_labels), train_labels), "val": (draw(val_labels), val_labels),
            "table": table, "init": init}


def offline_adapter(dev) -> dict:
    """``train_adapter`` at the real job's shape on the card, against a CPU
    run from the same initial weights."""
    from vlsat_tpu_torch.clipsem.adapter_train import train_adapter

    inp = adapter_inputs()
    (tf, tl), (vf, vl) = inp["train"], inp["val"]
    kw = dict(epochs=ADAPTER_EPOCHS, batch_size=ADAPTER_BATCH, init_params=inp["init"])
    hist = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, top1 = train_adapter(tf, tl, vf, vl, inp["table"], device=dev, history=hist, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    hist_cpu = {}
    t0 = time.perf_counter()
    _, top1_cpu = train_adapter(tf, tl, vf, vl, inp["table"], device="cpu", history=hist_cpu, **kw)
    cpu_secs = time.perf_counter() - t0
    got = torch.stack(hist["loss"][:ADAPTER_GATE_STEPS]).cpu().numpy()
    want = torch.stack(hist_cpu["loss"][:ADAPTER_GATE_STEPS]).numpy()
    if not np.allclose(got, want, rtol=1e-4, atol=0):
        fail(f"offline, adapter: the first {ADAPTER_GATE_STEPS} losses differ from the CPU "
             f"run by {np.abs(got / want - 1).max()} relative")
    if abs(top1 - top1_cpu) > 0.5:
        fail(f"offline, adapter: best top-1 {top1} against the CPU's {top1_cpu}")
    steps = len(hist["loss"])
    return {"train": int(len(tf)), "validation": int(len(vf)), "classes": int(len(inp["table"])),
            "batch": ADAPTER_BATCH, "epochs": ADAPTER_EPOCHS, "steps": steps,
            "steps_per_sec": steps / secs, "wall_s": secs, "cpu_wall_s": cpu_secs,
            "best_top1": top1, "best_top1_cpu": top1_cpu, "top1_per_epoch": hist["top1"],
            "first_losses_max_rel_diff": float(np.abs(got / want - 1).max())}


def write_sequences(scans_root: str) -> None:
    """PIPE_FRAMES colour frames (PNG files) and ``sequence/frames.json``
    for every scan."""
    from PIL import Image

    from vlsat_tpu_torch.data.ply import read_ply_vertices

    h, w = COLOR_HW
    rng = np.random.RandomState(SEED + 19)
    for scan in sorted(os.listdir(scans_root)):
        d = Path(scans_root) / scan
        pts = read_ply_vertices(str(d / "labels.instances.align.annotated.v2.ply")).points
        (d / "sequence").mkdir()
        meta = []
        for f, pose in enumerate(camera_rig(pts, PIPE_FRAMES)):
            name = f"frame-{f:06d}.color.png"
            img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
            Image.fromarray(img).save(d / "sequence" / name)
            meta.append({"color": name, "extrinsic": np.linalg.inv(pose).tolist()})
        (d / "sequence" / "frames.json").write_text(json.dumps({
            "frames": meta, "intrinsic": color_intrinsic().tolist(), "width": w, "height": h}))


def result_metrics(out_dir: Path) -> dict:
    text = (out_dir / "results" / "Mmgnet" / "default" / "result.txt").read_text()
    return dict(line[len("Eval: "):].rsplit(": ", 1) for line in text.splitlines())


def offline_pipeline(dev, root: str, scans_root: str, mv_root: str) -> dict:
    """``python -m vlsat_tpu_torch.tools.run_full_pipeline`` on the card
    (project, text, train, eval), the eval stage again on the CPU from its
    checkpoint, then ``align_scans`` and ``zero_shot_analysis`` on its outputs."""
    from vlsat_tpu_torch.tools import run_full_pipeline as pipeline
    from vlsat_tpu_torch.tools.align_scans import main as align_scans
    from vlsat_tpu_torch.tools.zero_shot_analysis import main as zero_shot

    here = Path(__file__).resolve().parent
    write_sequences(scans_root)
    cfg_path = OFFLINE_WORK / "cfg.json"
    cfg_path.write_text(json.dumps({
        "NAME": "Mmgnet", "SEED": SEED, "Batch_Size": TRAIN_BATCH, "MAX_EPOCHES": 1,
        "VALID_INTERVAL": 1, "LOG_INTERVAL": 1, "EVAL_BATCH_SIZE": TRAIN_BATCH}))
    out_dir = OFFLINE_WORK / "out"
    argv = ["--root", root, "--scans-root", scans_root, "--multi-view-root", mv_root,
            "--out", str(out_dir), "--config", str(cfg_path), "--encoder", "hash"]
    res = {}
    stages = "project,text,train,eval"
    reset_launches()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vlsat_tpu_torch.tools.run_full_pipeline",
                           *argv, "--stages", stages], cwd=here, capture_output=True, text=True,
                          timeout=600)
    res["command_s"] = time.perf_counter() - t0
    if proc.returncode:
        fail(f"offline, pipeline: run_full_pipeline exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"stage"')]
    res["stages"] = {r["stage"]: {"wall_s": r["wall_s"], **r["kernel_launches"]} for r in rows}
    if [r["stage"] for r in rows] != stages.split(","):
        fail(f"offline, pipeline: stages {[r['stage'] for r in rows]}")
    if res["stages"]["eval"]["segment_max"] <= 0 or res["stages"]["train"]["segment_max"] <= 0:
        fail(f"offline, pipeline: segment-max launches {res['stages']}")
    n_mv = sum(len(os.listdir(Path(scans_root) / s / "multi_view"))
               for s in os.listdir(scans_root))
    res["feature_files"] = n_mv
    card = result_metrics(out_dir)
    # the eval stage on the CPU, from the card run's checkpoint and text tables
    cpu_out = OFFLINE_WORK / "out_cpu"
    shutil.copytree(out_dir, cpu_out, ignore=shutil.ignore_patterns("results", "logs"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        pipeline.main([*argv[:6], "--out", str(cpu_out), *argv[8:], "--stages", "eval",
                       "--device", "cpu"])
    res["cpu_eval_s"] = time.perf_counter() - t0
    cpu = result_metrics(cpu_out)
    if card != cpu:
        diff = sorted(k for k in set(card) | set(cpu) if card.get(k) != cpu.get(k))
        fail(f"offline, pipeline: eval metrics differ from the CPU run's: {diff}")
    res["metrics"] = len(card)
    res["mean_recall_50"] = float(card.get("mean_recall_50", "nan"))
    # align_scans (rescans by their transform, references copied) and zero_shot_analysis
    scans = sorted(os.listdir(scans_root))
    mats = {s: np.eye(4) for s in scans[:OFFLINE_SCANS // 2]}
    for m in mats.values():
        m[3, :3] = [0.5, -1.0, 0.25]
    (OFFLINE_WORK / "3RScan.json").write_text(json.dumps([{"scans": [
        {"reference": s, "transform": m.reshape(-1).tolist()} for s, m in mats.items()]}]))
    (OFFLINE_WORK / "rescans.txt").write_text("\n".join(mats))
    (OFFLINE_WORK / "refs.txt").write_text("\n".join(scans[OFFLINE_SCANS // 2:]))
    with contextlib.redirect_stdout(io.StringIO()):
        n = align_scans(["--scans-root", scans_root, "--scan3r-json",
                         str(OFFLINE_WORK / "3RScan.json"), "--rescans",
                         str(OFFLINE_WORK / "rescans.txt"), "--references",
                         str(OFFLINE_WORK / "refs.txt"),
                         "--raw-name", "labels.instances.align.annotated.v2.ply",
                         "--out-name", "labels.realigned.ply"])
    from vlsat_tpu_torch.data.ply import read_ply_vertices

    for s in scans:
        a = read_ply_vertices(str(Path(scans_root) / s / "labels.instances.align.annotated.v2.ply"))
        b = read_ply_vertices(str(Path(scans_root) / s / "labels.realigned.ply"))
        want = a.points + (np.float32([0.5, -1.0, 0.25]) if s in mats else 0)
        if n != len(scans) or not np.allclose(b.points, want, atol=1e-5) or \
                not np.array_equal(a.instances, b.instances):
            fail(f"offline, align_scans: scan {s} ({n} written)")
    with contextlib.redirect_stdout(io.StringIO()):
        zs = zero_shot([
            "--results", str(out_dir / "results" / "Mmgnet" / "default"), "--root", root])
    if not zs or not all(np.isfinite(v) or np.isnan(v) for v in zs.values()):
        fail(f"offline, zero_shot_analysis: {zs}")
    res["aligned_scans"] = n
    res["zero_shot"] = {k: None if np.isnan(v) else v for k, v in zs.items()}
    return res


def offline(dev) -> dict:
    """Phase 15: the offline path on the card."""
    import importlib.util

    from vlsat_tpu_torch.data.assets import build_index
    from vlsat_tpu_torch.data.ply import read_ply_vertices

    if importlib.util.find_spec("PIL") is None:
        fail("offline: PIL is missing: it decodes the texture, view and colour frame files")
    shutil.rmtree(OFFLINE_WORK, ignore_errors=True)
    OFFLINE_WORK.mkdir(parents=True)
    out = {}
    t0 = time.perf_counter()
    root, scans_root, mv_root = offline_scans()
    index = build_index(root, "validation_scans")
    sizes = {a.scan: os.path.getsize(Path(scans_root) / a.scan
                                     / "labels.instances.align.annotated.v2.ply")
             for a in index.scenes}
    ann = next(a for a in index.scenes if a.scan == max(sizes, key=sizes.get))
    ply = read_ply_vertices(str(Path(scans_root) / ann.scan
                                / "labels.instances.align.annotated.v2.ply"))
    pts, inst = ply.points.astype(np.float32), ply.instances.astype(np.int32)
    out["setup_s"] = time.perf_counter() - t0
    reset_launches()
    out["depth"] = offline_depth(dev, pts, inst)
    log(f"offline, depth: {out['depth']['frames_per_sec']:.1f} frames/s (median of {DEPTH_REPS}) "
        f"({out['depth']['frames']} frames at {DEPTH_HW[1]}x{DEPTH_HW[0]}, stride "
        f"{DEPTH_STRIDE}, {len(pts)} labelled points); {out['depth']['near_tie_queries']} "
        f"near-tie queries, {out['depth']['assignments_differing']} assignments differ")
    out["projection"] = offline_projection(dev, pts, inst, ann.objects)
    log(f"offline, projection: {out['projection']['instances_per_sec']:.2f} instances/s "
        f"({out['projection']['frames']} frames at {COLOR_HW[1]}x{COLOR_HW[0]}); excluded "
        f"{out['projection']['excluded_points_near_border']} points near a border, "
        f"{out['projection']['excluded_boxes_near_integer']} of "
        f"{out['projection']['boxes_checked']} boxes near an integer")
    out["colour"] = offline_colour(pts, inst)
    out["adapter"] = offline_adapter(dev)
    log(f"offline, adapter: {out['adapter']['steps_per_sec']:.1f} steps/s, {ADAPTER_EPOCHS} "
        f"epochs (cut from the default 20 to keep the phase short) in "
        f"{out['adapter']['wall_s']:.1f} s; best top-1 {out['adapter']['best_top1']:.2f} "
        f"(CPU {out['adapter']['best_top1_cpu']:.2f})")
    out["pipeline"] = offline_pipeline(dev, root, scans_root, mv_root)
    log("offline, pipeline: stage walls " + json.dumps(
        {k: round(v["wall_s"], 2) for k, v in out["pipeline"]["stages"].items()}))
    launches = read_launches()
    for name, stage in (("segment_max", "segment_max"), ("pointnet_fused", "pointnet")):
        launches[name] += sum(s[stage] for s in out["pipeline"]["stages"].values())
    out["launches"] = launches
    shutil.rmtree(OFFLINE_WORK, ignore_errors=True)
    return out


TOOLS_WORK = WORK.parent / "tools"
TOOLS_SERVE = ["--max-batch", "32", "--clients", "64", "--duration", "4"]
PARITY_SCANS = 64          # labelled PLY scans of the parity runbook's split
PARITY_BATCH = 8           # the runbook's default --eval-batch-size
SOAK_SCANS = 1177          # the 3DSSG train split's scans, the soak's default
SOAK_CUTS = {"epochs": (20, 4), "kill_epoch": (12, 3), "valid_interval": (5, 2)}
SOAK_TIMEOUT_S = 900


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def tools_serve(total: dict) -> dict:
    """Phase 16, serve: the tool's runs in this process, its server against
    a CPU server on the same weights."""
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.serving import BatchedServer
    from vlsat_tpu_torch.tools import serve as tool

    out = {}
    reset_launches()
    t0 = time.perf_counter()
    res = tool.main([*TOOLS_SERVE, "--http", "--naive", "--out", str(TOOLS_WORK / "serve.json")])
    out["run_s"] = time.perf_counter() - t0
    launches = read_launches()
    add_launches(total, launches)
    if launches["segment_max"] <= 0 or launches["pointnet_fused"] or launches["pointnet_fused_v2"]:
        fail(f"tools, serve: launches {launches} (segment-max expected, PointNet not)")
    out["launches"] = launches
    for key in ("batched", "http", "naive_per_scene_dispatch"):
        if not res[key]["scenes_per_sec"] > 0:
            fail(f"tools, serve: {key} {res[key]}")
        out[key] = res[key]
    log(f"tools, serve: batched {res['batched']['scenes_per_sec']:.1f} / http "
        f"{res['http']['scenes_per_sec']:.1f} / naive "
        f"{res['naive_per_scene_dispatch']['scenes_per_sec']:.1f} scenes/s; launches {launches}")

    args = tool.parse_args(TOOLS_SERVE)
    model = tool.load_served(args)
    cpu_model = build_mmgnet(MMGNetConfig(), "cpu")
    cpu_model.load_state_dict(model.state_dict())
    pool = tool.request_pool()[:4]
    with tool.build_server(args, model) as server:
        got = [server.predict(s, timeout=600) for s in pool]
    with BatchedServer(cpu_model, device="cpu", max_batch=1, pad_to_max=False) as cpu:
        want = [cpu.predict(s, timeout=600) for s in pool]
    diff = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        for key in ("obj_logits", "rel_cls"):
            if g[key].shape != w[key].shape or \
                    not np.allclose(g[key], w[key], rtol=1e-3, atol=1e-4):
                fail(f"tools, serve: {key} of pool scene {k} differs from the CPU server: "
                     f"max abs {np.abs(g[key] - w[key]).max()}")
            diff = max(diff, float(np.abs(g[key] - w[key]).max()))
    out["served_vs_cpu_max_abs_diff"] = diff
    del model, server

    art = TOOLS_WORK / "artifact"
    t0 = time.perf_counter()
    exp = tool.main(["--max-batch", "32", "--export-artifact", str(art)])
    out["artifact_export_s"] = time.perf_counter() - t0
    if exp["buckets"] != [12, 16] or "obj_logits_3d" not in exp["outputs"]:
        fail(f"tools, serve: exported {exp}")
    reset_launches()
    t0 = time.perf_counter()
    res = tool.main(["--artifact", str(art), "--clients", "64", "--duration", "4", "--naive"])
    out["artifact_run_s"] = time.perf_counter() - t0
    launches = read_launches()
    add_launches(total, launches)
    if launches["segment_max"] <= 0 or not res["batched"]["scenes_per_sec"] > 0 or \
            "naive_per_scene_dispatch" in res:
        fail(f"tools, serve: artifact run {res}, launches {launches}")
    out["artifact"] = res["batched"]
    log(f"tools, serve: from the artifact {res['batched']['scenes_per_sec']:.1f} scenes/s "
        f"(export {out['artifact_export_s']:.1f} s, load and run {out['artifact_run_s']:.1f} s)")

    reset_launches()
    res = tool.main(["--max-batch", "32", "--sweep", "--sweep-clients", "1", "4", "16", "64",
                     "--duration", "2"])["batched"]
    add_launches(total, read_launches())
    curve = res["curve"]
    if [r["clients"] for r in curve] != [1, 4, 16, 64] or res["knee"] not in curve or \
            not all(r["scenes_per_sec"] > 0 and np.isfinite(r["p99_latency_ms"]) for r in curve) \
            or (res["deadline_operating_point"] is not None
                and res["deadline_operating_point"] not in curve):
        fail(f"tools, serve: sweep {res}")
    out["sweep"] = res
    log(f"tools, serve: sweep knee {res['knee']}, operating point within "
        f"{res['deadline_p99_ms']} ms p99 {res['deadline_operating_point']}")
    return out


def tools_parity(total: dict) -> dict:
    """Phase 16, parity_eval: a seeded reference ``.pth`` directory on a
    labelled PLY split, on the CPU, then on the card against the CPU's
    ``result.txt``."""
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split, validation_scene_stats
    from vlsat_tpu_torch.tools import parity_eval as tool

    d = TOOLS_WORK / "parity"
    t0 = time.perf_counter()
    reference_module_files(d / "ckpt", SEED + 21)
    nodes, rels = validation_scene_stats(PARITY_SCANS, seed=SEED + 21)
    root, scans, _ = make_synthetic_split(
        str(d / "split"), num_scans=PARITY_SCANS, node_counts=nodes, rel_counts=rels,
        vertices_per_inst=VERTS_PER_INST, seed=SEED + 21, write_ply=True,
        background_verts=BG_VERTS)
    out = {"scans": PARITY_SCANS, "eval_batch_size": PARITY_BATCH,
           "setup_s": time.perf_counter() - t0}
    argv = ["--ckpt-dir", str(d / "ckpt"), "--root", root, "--scans", scans,
            "--eval-batch-size", str(PARITY_BATCH)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = tool.main([*argv, "--device", "cpu", "--out-json", str(d / "cpu.json")])
    out["cpu_s"] = time.perf_counter() - t0
    if rc:
        fail(f"tools, parity_eval: the CPU run exited {rc}")
    cpu = json.loads((d / "cpu.json").read_text())["metrics"]
    labels = {key: label for label, key in tool.REF_LABEL_TO_KEY.items()}
    (d / "result.txt").write_text("".join(
        f"Eval: {labels[k]} : {v!r}\n" for k, v in cpu.items() if k in labels and np.isfinite(v)))
    reset_launches()
    report = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        rc = tool.main([*argv, "--reference", str(d / "result.txt"),
                        "--out-json", str(d / "card.json")])
    out["card_s"] = time.perf_counter() - t0
    launches = read_launches()
    add_launches(total, launches)
    if rc or "parity within ±0.5 pts: YES" not in report.getvalue():
        fail(f"tools, parity_eval: the card run exited {rc}: {report.getvalue()[-3000:]}")
    batches = -(-PARITY_SCANS // PARITY_BATCH)
    if launches["segment_max"] != 4 * batches:
        fail(f"tools, parity_eval: {launches['segment_max']} segment-max launches for "
             f"{batches} batches (4 a batch expected)")
    card = json.loads((d / "card.json").read_text())
    diffs = {k: abs(card["metrics"][k] - v) for k, v in cpu.items()
             if np.isfinite(v) and np.isfinite(card["metrics"][k])}
    worst = max(diffs, key=diffs.get)
    out.update(launches=launches, compared=len(card["reference"]), ok=card["ok"],
               max_metric_diff=diffs[worst], max_metric_diff_key=worst,
               mean_recall_50=cpu["mean_recall_50"])
    log(f"tools, parity_eval: {len(card['reference'])} reference metrics, verdict YES; largest "
        f"card-against-CPU difference {diffs[worst]} ({worst}); launches {launches}")
    return out


def tools_soak(here: Path) -> dict:
    """Phase 16, soak: ``python -m vlsat_tpu_torch.tools.soak`` in its own
    process group (its training child included), killed whole on timeout."""
    import signal

    out_json = TOOLS_WORK / "soak.json"
    cmd = [sys.executable, "-m", "vlsat_tpu_torch.tools.soak", "--num-scans", str(SOAK_SCANS),
           "--epochs", str(SOAK_CUTS["epochs"][1]),
           "--kill-epoch", str(SOAK_CUTS["kill_epoch"][1]),
           "--valid-interval", str(SOAK_CUTS["valid_interval"][1]), "--batch-size", "8",
           "--base", str(TOOLS_WORK / "soak"), "--out", str(out_json),
           "--timeout", str(SOAK_TIMEOUT_S)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=SOAK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"tools, soak: no end within {SOAK_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail(f"tools, soak exited {proc.returncode}: {stderr[-2000:]} {stdout[-2000:]}")
    res = json.loads(out_json.read_text())
    kill, last = SOAK_CUTS["kill_epoch"][1], SOAK_CUTS["epochs"][1]
    rows = res["epoch_stats"]
    if [e["epoch"] for e in rows[:res["phase_a_epochs"]]] != list(range(1, kill)) or \
            res["phase_b_rc"] != 0 or not res["resumed_within_one_epoch_of_kill"] or \
            res["final_epoch"] != last:
        fail(f"tools, soak: {json.dumps({k: v for k, v in res.items() if k != 'epoch_stats'})}")
    vals = [v["mean_recall_50"] for v in res["val_trajectory"]]
    if len(vals) != last // SOAK_CUTS["valid_interval"][1] or not np.isfinite(vals).all():
        fail(f"tools, soak: validation trajectory {res['val_trajectory']}")
    # the tool's steady rate leaves out every validating epoch, and at this
    # cut every epoch past each phase's first validates: here each epoch's
    # train rate is its scenes over its wall less its validation
    first_b = rows[res["phase_a_epochs"]]
    train_rates = [e["scenes"] / (e["wall_s"] - e.get("val_wall_s", 0.0))
                   for e in rows[1:] if e is not first_b]
    out = {k: res[k] for k in ("num_scans", "dataset_build_s", "phase_a_wall_s",
                               "phase_a_epochs", "phase_b_wall_s", "resume_epoch",
                               "final_epoch", "val_trajectory", "peak_rss_mb", "peak_hbm_mb",
                               "steady_train_scenes_per_sec")}
    out.update(command_s=wall, train_scenes_per_sec=float(np.median(train_rates)),
               train_scenes_per_sec_epochs=train_rates,
               val_wall_s=[e["val_wall_s"] for e in rows if "val_wall_s" in e],
               cuts={k: f"{a} -> {b}" for k, (a, b) in SOAK_CUTS.items()},
               launches="not counted: the training child is another process")
    out_json.unlink()
    log(f"tools, soak: {SOAK_SCANS} scans, killed in epoch {kill}, resumed at "
        f"{res['resume_epoch']}, phase B rc 0; train {out['train_scenes_per_sec']:.1f} "
        f"scenes/s; walls A {res['phase_a_wall_s']} / B {res['phase_b_wall_s']} s")
    return out


def tools_phase() -> dict:
    """Phase 16: the serving and operations tools on the card."""
    here = Path(__file__).resolve().parent
    shutil.rmtree(TOOLS_WORK, ignore_errors=True)
    TOOLS_WORK.mkdir(parents=True)
    total = {}
    out = {"serve": tools_serve(total), "parity_eval": tools_parity(total)}
    torch.cuda.empty_cache()  # the soak's child trains on the same card
    out["soak"] = tools_soak(here)
    out["launches"] = total
    shutil.rmtree(TOOLS_WORK, ignore_errors=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA card")
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.ops.kernels import build
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.serving import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    walls, t_mark = {}, [time.monotonic()]

    def mark(phase: str) -> None:
        now = time.monotonic()
        walls[phase] = round(now - t_mark[0], 1)
        t_mark[0] = now

    # 1. build
    t0 = time.monotonic()
    build.build(["segment_max", "pointnet"])
    log(f"build: {time.monotonic() - t0:.1f} s for segment_max.cu and pointnet.cu (parallel nvcc)")
    for name, (secs, out) in build.build_log.items():
        usage = [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
        log(f"  {name}.cu built in {secs:.1f} s; ptxas: {' | '.join(usage)}")

    # 2-3. kernels against their twins, and times
    rng = np.random.RandomState(SEED)
    kernels = check_segment_max(dev, rng) + check_pointnet(dev, rng)
    mark("build_and_kernels")

    # 4. full-width model
    cfg = MMGNetConfig(fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=SEED)
    srng = np.random.RandomState(SEED + 1)
    scenes = [make_scene(srng, int(n)) for n in srng.randint(4, 41, size=48)]
    scenes[0] = make_scene(srng, 40)  # the largest size is always served

    # 5. the main path, with every launch counter at 0 just before
    segment_max.launches = 0
    pointnet_kernel.launches = 0
    pointnet_kernel.launches_v2 = 0
    t0 = time.monotonic()
    results, bench = serve(model, dev, scenes)
    counts = {"segment_max": segment_max.launches,
              "pointnet_fused": pointnet_kernel.launches - pointnet_kernel.launches_v2,
              "pointnet_fused_v2": pointnet_kernel.launches_v2}
    log(f"serving: {len(scenes)} scenes + load run in {time.monotonic() - t0:.1f} s; "
        f"kernel launches {counts}")
    for s, r in zip(scenes, results):
        n = s["obj_points"].shape[0]
        if r["obj_logits"].shape != (n, cfg.num_obj_classes) or \
                r["rel_cls"].shape != (n * (n - 1), cfg.num_rel_classes):
            fail(f"served shapes {r['obj_logits'].shape}, {r['rel_cls'].shape} for n={n}")
        if not (np.isfinite(r["obj_logits"]).all() and np.isfinite(r["rel_cls"]).all()):
            fail(f"non-finite served output for a scene of {n} nodes")
    for name in ("segment_max", "pointnet_fused"):  # v2 is not on the serving path
        if counts[name] <= 0:
            fail(f"the serving run never launched the {name} kernel")
    for k in kernels:
        k["launches"] = counts[k["name"]]

    # 6. the same weights on the CPU, scene by scene
    picks = [0, 1, 2, 3]
    cpu_server = BatchedServer(model, device="cpu", max_batch=1, pad_to_max=False)
    with cpu_server:
        for k in picks:
            ref = cpu_server.predict(scenes[k], timeout=600)
            for key in ("obj_logits", "rel_cls"):
                got = results[k][key]
                if not np.allclose(got, ref[key], rtol=1e-3, atol=1e-4):
                    fail(f"{key} of scene {k} ({scenes[k]['obj_points'].shape[0]} nodes) "
                         f"differs from the CPU run: max abs {np.abs(got - ref[key]).max()}")
    log(f"served outputs of scenes {picks} match the CPU run (rtol 1e-3, atol 1e-4)")

    # 7. where one batch's time goes
    log(json.dumps({"profile": profile_forward(model, dev, scenes)}))
    mark("serving")

    # 8. the evaluation path
    ev = evaluation(model, dev, cfg)
    for k in kernels:
        k["launches_eval"] = ev["launches"].get(k["name"], 0)
    log(json.dumps({"evaluation": ev}))
    log(json.dumps({"serving": {**bench, "scenes": len(scenes), "max_batch": BATCH}}))
    mark("evaluation")

    # 9. the training step
    tr = training(dev)
    for k in kernels:
        k["launches_train"] = tr["launches"].get(k["name"], 0)
    log(json.dumps({"training": tr}))
    mark("training")

    # 10. the data feed
    feed = data_feed(model, dev, cfg)
    for k in kernels:
        k["launches_data_feed"] = feed["launches"].get(k["name"], 0)
    for name in ("segment_max", "pointnet_fused"):
        if feed["launches"][name] <= 0:
            fail(f"the data-feed evaluation never launched the {name} kernel")
    log(json.dumps({"data_feed": feed}))
    mark("data_feed")

    # 11. the runner and the CLI
    run = runner(dev)
    for k in kernels:
        k["launches_runner"] = run["launches"].get(k["name"], 0)
    log(json.dumps({"runner": run}))
    mark("runner")

    # 12. the model zoo
    zoo = variants(dev)
    for k in kernels:
        k["launches_variants"] = zoo["launches"].get(k["name"], 0)
    log(json.dumps({"variants_detail": zoo}))
    log(json.dumps({"variants": {
        name: {"eval_scenes_per_sec": m["eval"]["scenes_per_sec"],
               "eval_wall_ms_per_batch": m["eval"]["wall_ms_per_batch"],
               "trained_scenes_per_sec": m["train"]["scenes_per_sec"],
               "step_wall_ms": m["train"]["step_wall_ms"],
               "peak_memory_gib": max(m["eval"]["peak_memory_gib"],
                                      m["train"]["peak_memory_gib"]),
               "segment_max_launches": m["eval"]["launches"]["segment_max"],
               "knn_set_mismatches": sum(c.get("knn_set_mismatches", 0) for c in m["checks"])}
        for name, m in zoo["models"].items()}}))
    mark("variants")
    # 13. the deployment artifacts
    exp = export_phase(model, dev, scenes)
    for k in kernels:
        k["launches_export"] = exp["launches"].get(k["name"], 0)
    log(json.dumps({"export": exp}))
    mark("export")
    # 14. data parallelism
    dp = data_parallel(dev)
    for k in kernels:
        k["launches_data_parallel"] = dp["launches"].get(k["name"], 0)
    log(json.dumps({"data_parallel": dp}))
    mark("data_parallel")
    # 15. the offline path
    off = offline(dev)
    for k in kernels:
        k["launches_offline"] = off["launches"].get(k["name"], 0)
    log(json.dumps({"offline": off}))
    mark("offline")
    # 16. the serving and operations tools
    tl = tools_phase()
    for k in kernels:
        k["launches_tools"] = tl["launches"].get(k["name"], 0)
    log(json.dumps({"tools": tl}))
    mark("tools")
    log(json.dumps({"phase_wall_s": walls}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
