"""How far fp32 rounding alone moves one train step's gradients.

    python tools/torch_grad_noise.py [--device cpu|cuda]

Takes the bucket-12 batch that ``chip_smoke.py``'s training phase holds the
card against the CPU with (full-width MMGNet, B=8, text targets, every
dropout off, batch-statistics BatchNorm) and computes the gradient of
``vlsat_total_loss`` four ways: fp32, fp64, and both again with every weight
perturbed by 1e-7 relative noise.  For each pair it prints the leaves
outside the gate of tests/test_parity_torch.py:568-575 (isclose, rtol
2e-3, atol 2e-3 * max|g| of the leaf, floored at 1e-6 of the largest
gradient): the leaves that rounding moves, since fp32 decides near-ties in
the max aggregations and ReLUs that fp64 resolves.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet  # noqa: E402
from vlsat_tpu_torch.train.losses import vlsat_total_loss  # noqa: E402


def gradients(batch, dev, dtype, perturb: float = 0.0) -> dict:
    model = C.dropout_off(build_mmgnet(MMGNetConfig(), device=dev, seed=C.SEED + 5))
    model = model.to(dtype).train()
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g, dtype=dtype).to(dev))
    b = C.as_dtype(batch, dtype).to(dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    vlsat_total_loss(model(b, istrain=True, rng=rng), b)[0].backward()
    return {n: p.grad.double().cpu() for n, p in model.named_parameters() if p.grad is not None}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    dev = torch.device(ap.parse_args().device)
    torch.backends.cuda.matmul.allow_tf32 = False
    splits = C.labelled_splits(C.SEED + 3, batch=C.TRAIN_BATCH,
                               large=(("b48", 33, 48, 3 * C.TRAIN_BATCH),), with_text=True)
    batch = next(b for b in splits["val"] if b.num_nodes == 12)
    runs = {(dt, eps): gradients(batch, dev, dt, eps)
            for dt in (torch.float32, torch.float64) for eps in (0.0, 1e-7)}
    pairs = {"fp32 against fp64": ((torch.float32, 0.0), (torch.float64, 0.0)),
             "fp32 perturbed against fp32": ((torch.float32, 1e-7), (torch.float32, 0.0)),
             "fp64 perturbed against fp64": ((torch.float64, 1e-7), (torch.float64, 0.0))}
    for title, (a, b) in pairs.items():
        got, want = runs[a], runs[b]
        floor = 1e-6 * max(w.abs().max().item() for w in want.values())
        bad = []
        for n, w in want.items():
            scale = max(w.abs().max().item(), floor)
            ok = torch.isclose(got[n], w, rtol=2e-3, atol=2e-3 * scale)
            if not ok.all():
                bad.append(f"{n}: {int((~ok).sum())} of {ok.numel()} outside, max abs diff "
                           f"{(got[n] - w).abs().max().item():.3g} at max|g| {scale:.3g}")
        print(f"{title} on {dev}: {len(bad)} of {len(want)} leaves outside the gate")
        for line in bad:
            print("  " + line)


if __name__ == "__main__":
    main()
