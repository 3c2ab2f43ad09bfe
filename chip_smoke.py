"""The port's CUDA kernels on one NVIDIA card: built, held against their
plain PyTorch twins at the served shapes, and timed against their bounds.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build the CUDA kernels of ``vlsat_tpu_torch/csrc`` with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch twin on the card at the
   serving path's shapes (node buckets 16, 48 and 64, 32 scenes; the fused
   PointNet also in its point-chunked v2 configuration, and as SGPN's
   union-cloud encoder, 4 -> 64 -> 128 -> 256 over 256 points, at the
   packed rows of a small and a full batch of served rooms; the EdgeConv
   kernel at the served SGGpoint room's buckets 8 and 64, P=128, k=20, in
   each of the DGCNN's four stages): segment-max and EdgeConv must be
   bit-equal, PointNet within rtol 1e-4 / atol 1e-5 (3xTF32 products on
   the tensor cores against cuBLAS fp32);
3. time each kernel, its twin and the one-call library yardstick with CUDA
   events (for EdgeConv the dense stage it replaces, and the projection and
   kernel together), and compute each kernel's bound from its shapes:
   segment-max and EdgeConv by bytes, PointNet by operations at the 3xTF32
   rate (three TF32 products per fp32 product at 495 TFLOP/s), with the
   share of the bound reached.

Every other path of the port is checked on the card by
``python -m pytest --noconftest -q tests/test_torch_port_cuda.py``, and
measured end to end by ``benchmark/``.

The last lines are a JSON ``kernels`` line (one row a kernel, bucket and
stage), the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12        # H100 SXM TF32 tensor cores, dense (data sheet)
SEED = 0
BATCH = 32
BUCKETS = (16, 48, 64)     # node buckets of the served flagship's scenes


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


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


def pointnet_row(name: str, replaces: str, shape: str, got, want, fn, plain_ms: float,
                 dims, m: int, p: int, inputs: int) -> dict:
    """A PointNet row of the ``kernels`` line: the kernel timed against its
    bound (its FLOPs as 3xTF32 products, or its bytes: ``inputs`` floats in,
    (m, out) out) and its twin."""
    flops = 2 * m * p * sum(a * b for a, b in zip(dims, dims[1:]))
    nbytes = (inputs + m * dims[-1]) * 4
    ms = cuda_ms(fn)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3
    return {
        "name": name, "route": "cuda", "source": "vlsat_tpu_torch/csrc/pointnet.cu",
        "replaces": replaces, "shape": shape,
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


def check_pointnet(dev, rng) -> list:
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    dims = (3, 64, 128, 768)
    # weights as nn.Linear holds them, (out, in), passed as (in, out) views
    # the way the model passes them
    ws = [torch.from_numpy((rng.randn(b, a) / np.sqrt(a)).astype(np.float32)).to(dev).t()
          for a, b in zip(dims, dims[1:])]
    bs = [torch.from_numpy((rng.randn(b) * 0.1).astype(np.float32)).to(dev) for b in dims[1:]]
    weights = sum(w.numel() for w in ws) + sum(b.numel() for b in bs)
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
            row = pointnet_row(
                name, ("vlsat_tpu/ops/pallas/pointnet_kernel.py:99" if name == "pointnet_fused"
                       else "vlsat_tpu/ops/pallas/pointnet_kernel.py:150"),
                f"B={BATCH} N={n} P=128 C=3 widths=64,128,768"
                + (" p_chunk=16" if name.endswith("v2") else ""),
                got, want, fn, plain_ms, dims, BATCH * n, 128, pts.numel() + weights)
            log(f"{name} bucket {n}: within rtol 1e-4/atol 1e-5 of its twin; "
                + json.dumps(row))
            rows.append(row)
    return rows


UNION_ROWS = (4096, 26112)  # packed edge rows: a few rooms, and 32 rooms of the mean 816 edges


def check_union_pointnet(dev, rng) -> list:
    """The fused PointNet as SGPN's relation encoder: 256-point union clouds
    (xyz and a 0 / 1 / 2 mask channel), 4 -> 64 -> 128 -> 256."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    dims, p = (4, 64, 128, 256), 256
    ws = [torch.from_numpy((rng.randn(b, a) / np.sqrt(a)).astype(np.float32)).to(dev).t()
          for a, b in zip(dims, dims[1:])]
    bs = [torch.from_numpy((rng.randn(b) * 0.02).astype(np.float32)).to(dev) for b in dims[1:]]
    weights = sum(w.numel() for w in ws) + sum(b.numel() for b in bs)
    rows = []
    for m in UNION_ROWS:
        pts = np.concatenate([rng.randn(m, p, 3), rng.randint(0, 3, (m, p, 1))], axis=-1)
        pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
        want = K.pointnet_encode_plain(pts, ws, bs)
        fn = lambda: K.pointnet_encode_fused(pts, ws, bs)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            fail(f"pointnet_fused differs from its twin at {m} union rows: max abs "
                 f"{(got - want).abs().max().item()}")
        row = pointnet_row("pointnet_fused", "vlsat_tpu/ops/pallas/pointnet_kernel.py:99",
                           f"R={m} P={p} C=4 widths=64,128,256 (SGPN union clouds)", got, want,
                           fn, cuda_ms(lambda: K.pointnet_encode_plain(pts, ws, bs), iters=5),
                           dims, m, p, pts.numel() + weights)
        log(f"pointnet_fused {m} union rows: within rtol 1e-4/atol 1e-5 of its twin; "
            + json.dumps(row))
        rows.append(row)
    return rows


EDGECONV_BUCKETS = (8, 64)  # the served SGGpoint room's smallest and largest buckets
EDGECONV_STAGES = ((3, 64), (64, 64), (64, 128), (128, 256))  # the DGCNN's (C_in, C_out)


def check_edgeconv(dev, rng) -> list:
    """The EdgeConv kernel at the served shapes (B=32, P=128, k=20, each
    stage): bit-equal to its twin on the card from the same projection, and
    timed against its bytes bound, the twin and the dense stage it
    replaces (gather, Linear, eval BatchNorm, leaky ReLU, max over k)."""
    from torch.nn import functional as F

    from vlsat_tpu_torch.ops import dgcnn
    from vlsat_tpu_torch.ops.kernels import edgeconv as K

    eps, p, k = 1e-5, 128, 20
    rows = []
    for n in EDGECONV_BUCKETS:
        for c_in, c_out in EDGECONV_STAGES:
            x = rng.randn(BATCH, n, p, c_in).astype(np.float32)
            if c_in > 3:  # a later stage's input is a leaky ReLU's output
                x = np.where(x > 0, x, 0.2 * x)
            x[BATCH // 2:, n // 2:] = 0.0  # padded slots: all-zero clouds
            x = torch.from_numpy(x).to(dev)
            weight = torch.from_numpy((rng.randn(c_out, 2 * c_in) / np.sqrt(2 * c_in)
                                       ).astype(np.float32)).to(dev)
            gamma = rng.randn(c_out)
            gamma[::2] = -np.abs(gamma[::2])  # negative scales: no max/min shortcut passes
            mean, var, scale, shift = (torch.from_numpy(v.astype(np.float32)).to(dev) for v in (
                rng.randn(c_out) * 0.2, rng.rand(c_out) + 0.5, gamma, rng.randn(c_out) * 0.1))
            uw, idx = dgcnn.project_pairs(x, weight), dgcnn.knn_indices(x, k)
            before = K.launches
            got = K.edgeconv_max_cuda(uw, idx, mean, var, scale, shift, eps)
            want = K.edgeconv_max_plain(uw, idx, mean, var, scale, shift, eps)
            torch.cuda.synchronize()
            if K.launches != before + 1:
                fail(f"edgeconv_max: {K.launches - before} launches for one call")
            if not torch.equal(got, want):
                fail(f"edgeconv_max differs from its twin at bucket {n}, stage {c_in}-{c_out}: "
                     f"max abs {(got - want).abs().max().item()}")

            def dense():
                h = F.linear(dgcnn.graph_feature(x, k=k, idx=idx), weight)
                h = (h - mean) / torch.sqrt(var + eps) * scale + shift
                return F.leaky_relu(h, 0.2).amax(dim=-2)

            m = BATCH * n
            nbytes = uw.numel() * 4 + idx.numel() * 8 + 4 * c_out * 4 + m * p * c_out * 4
            ms = cuda_ms(lambda: K.edgeconv_max_cuda(uw, idx, mean, var, scale, shift, eps))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            iters = 20 if n <= 8 else 5  # a bucket-64 dense stage moves up to 5.4 GB a pass
            row = {
                "name": "edgeconv_max", "route": "cuda",
                "source": "vlsat_tpu_torch/csrc/edgeconv.cu",
                "replaces": "none: XLA's dense EdgeConv (vlsat_tpu/models/sggpoint.py DGCNN)",
                "shape": f"B={BATCH} N={n} P={p} k={k} C_in={c_in} C_out={c_out}",
                "max_abs_err": (got - want).abs().max().item(),
                "ms": ms,
                "plain_ms": cuda_ms(lambda: K.edgeconv_max_plain(
                    uw, idx, mean, var, scale, shift, eps), iters=iters, warmup=1),
                "bound_ms": bound_ms,
                "bound_by": "bytes",
                "bound_rate": "HBM3 at 3.35 TB/s",
                "share_of_bound": bound_ms / ms,
                "library_ms": cuda_ms(dense, iters=iters, warmup=1),
                "stage_ms": cuda_ms(lambda: K.edgeconv_max_cuda(
                    dgcnn.project_pairs(x, weight), idx, mean, var, scale, shift, eps)),
            }
            del got, want
            log(f"edgeconv_max bucket {n}, stage {c_in}-{c_out}: bit-equal to its twin; "
                + json.dumps(row))
            rows.append(row)
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA card")
    from vlsat_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.monotonic()
    build.build(["segment_max", "pointnet", "edgeconv"])
    log(f"build: {time.monotonic() - t0:.1f} s for segment_max.cu, pointnet.cu and edgeconv.cu "
        "(parallel nvcc)")
    for name, (secs, out) in build.build_log.items():
        usage = [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
        log(f"  {name}.cu built in {secs:.1f} s; ptxas: {' | '.join(usage)}")

    # 2-3. kernels against their twins, and times
    rng = np.random.RandomState(SEED)
    kernels = check_segment_max(dev, rng) + check_pointnet(dev, rng) + check_edgeconv(dev, rng)
    kernels += check_union_pointnet(dev, np.random.RandomState(SEED + 1))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
