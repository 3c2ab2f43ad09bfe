"""Encoder-only throughput on the card (the port's twin of
``tools/bench_encoders.py``):

    python -m vlsat_tpu_torch.tools.bench_encoders [--scenes 548] [--nodes 9]
        [--points 128] [--device cpu]

The PointNet object encoder (3->64->128->768 with ReLUs, a max over the 128
points of each instance) over a 3DSSG-validation-sized split (548
scan-splits of ~9 instances), plain (``ops.pointnet.pointnet_encode``, fp32
cuBLAS with TF32 off) against the fused kernel
(``ops.kernels.pointnet_kernel.pointnet_encode_fused``, 3xTF32); then the
11->512 relation encoder over the same split's edge descriptors (the plain
chain at P=1, as in JAX).  Times are the median of 3 spans of ``CALLS``
back-to-back calls between CUDA events, after a warm-up call.  The fused
output is held against the plain one at the kernel gate (rtol 1e-4, atol
1e-5).  Inputs and weights are JAX's draws (``np.random.RandomState(0)``).
``main(argv)`` returns the JSON it prints.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

OBJ_DIMS = ((3, 64), (64, 128), (128, 768))
REL_DIMS = ((11, 64), (64, 128), (128, 512))
RTOL, ATOL = 1e-4, 1e-5  # the kernel gate (3xTF32 against fp32)
CALLS = 20


def encoder_inputs(scenes: int, nodes: int, points: int) -> dict:
    """The JAX tool's draws: points (scenes*nodes, points, 3), then the
    object encoder's weights, then the relation encoder's (biases zero)."""
    rng = np.random.RandomState(0)
    pts = rng.randn(scenes * nodes, points, 3).astype(np.float32)
    ws = [(rng.randn(a, b) * 0.1).astype(np.float32) for a, b in OBJ_DIMS]
    ws_r = [(rng.randn(a, b) * 0.1).astype(np.float32) for a, b in REL_DIMS]
    return {"pts": pts, "ws": ws, "bs": [np.zeros(b, np.float32) for _, b in OBJ_DIMS],
            "ws_r": ws_r, "bs_r": [np.zeros(b, np.float32) for _, b in REL_DIMS]}


def object_encoder(pts, ws, bs, fused: bool) -> torch.Tensor:
    from vlsat_tpu_torch.ops.kernels.pointnet_kernel import pointnet_encode_fused
    from vlsat_tpu_torch.ops.pointnet import pointnet_encode

    return (pointnet_encode_fused if fused else pointnet_encode)(pts, ws, bs)


def relation_encoder(pts, edge_index, ws_r, bs_r, scenes: int, nodes: int) -> torch.Tensor:
    """Edge descriptors of every ordered instance pair through the 11->512
    chain: (scenes, nodes*(nodes-1), 512)."""
    from vlsat_tpu_torch.ops.descriptor import edge_descriptor, gen_descriptor
    from vlsat_tpu_torch.ops.pointnet import pointnet_encode

    desc = gen_descriptor(pts.reshape(scenes, nodes, pts.shape[-2], 3))
    return pointnet_encode(edge_descriptor(desc, edge_index)[..., None, :], ws_r, bs_r)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", type=int, default=548)
    p.add_argument("--nodes", type=int, default=9)
    p.add_argument("--points", type=int, default=128)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (the card by default; cpu for smoke tests)")
    args = p.parse_args(argv)

    from vlsat_tpu_torch.device import resolve_device
    from vlsat_tpu_torch.scene import full_edge_index
    from vlsat_tpu_torch.tools.bench import time_calls

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain route in fp32
    inp = encoder_inputs(args.scenes, args.nodes, args.points)
    on = lambda xs: [torch.from_numpy(x).to(dev) for x in xs]
    pts = torch.from_numpy(inp["pts"]).to(dev)
    ws, bs, ws_r, bs_r = on(inp["ws"]), on(inp["bs"]), on(inp["ws_r"]), on(inp["bs_r"])
    m, n = args.scenes * args.nodes, args.nodes

    want = object_encoder(pts, ws, bs, fused=False)
    got = object_encoder(pts, ws, bs, fused=True)
    err = float((got - want).abs().max())
    t_plain = time_calls(lambda: object_encoder(pts, ws, bs, False), CALLS, dev)[0]
    t_fused = time_calls(lambda: object_encoder(pts, ws, bs, True), CALLS, dev)[0]

    ei = torch.from_numpy(np.broadcast_to(full_edge_index(n)[None],
                                          (args.scenes, n * (n - 1), 2)).copy()).to(dev)
    t_rel = time_calls(lambda: relation_encoder(pts, ei, ws_r, bs_r, args.scenes, n),
                       CALLS, dev)[0]
    res = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "scenes": args.scenes, "nodes": n, "instances": m, "points": args.points,
        "object_encoder": {
            "plain_ms": t_plain * 1e3, "fused_ms": t_fused * 1e3,
            "plain_scenes_per_sec": args.scenes / t_plain,
            "fused_scenes_per_sec": args.scenes / t_fused,
            "max_abs_err": err,
            "within_gate": bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))},
        "relation_encoder": {"edges": args.scenes * n * (n - 1), "ms": t_rel * 1e3,
                             "scenes_per_sec": args.scenes / t_rel},
    }
    print(f"object encoder over {args.scenes} scenes x {n} nodes "
          f"({m} instances x {args.points} pts):")
    print(f"  plain: {t_plain * 1e3:7.3f} ms  ({args.scenes / t_plain:9.0f} scenes/s)")
    print(f"  fused: {t_fused * 1e3:7.3f} ms  ({args.scenes / t_fused:9.0f} scenes/s); "
          f"max abs diff {err:.3g}")
    print(f"relation encoder over {args.scenes * n * (n - 1)} edges: {t_rel * 1e3:7.3f} ms "
          f"({args.scenes / t_rel:9.0f} scenes/s)")
    print(json.dumps({"encoders": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
