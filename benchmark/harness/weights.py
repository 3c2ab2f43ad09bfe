"""Seeded weights in the layout of the original reference's checkpoints.

The benchmark draws every weight of a reference module (``benchmark/
reference/oracle.py``, whose child-module names and ``Sequential`` indices
are those of the released ``.pth`` files) from the seed, on the device, in
one ``torch.randn`` call from a ``torch.Generator`` there, and scales the
slices leaf by leaf:

* matrices and convolution kernels: LeCun normal, ``z / sqrt(fan_in)``;
* biases: ``0.02 z``; LayerNorm / BatchNorm scales: ``1 + 0.02 z``;
* BatchNorm running means ``0.1 z``, running variances ``1 + 0.1 |z|``;
* the cosine classifiers' ``obj_logit_scale``: log(1 / 0.07).

The program receives the same weights through its own checkpoint import
(``interop.torch_import``), as users load released checkpoints; the
reference uses the module as it is.
"""

from __future__ import annotations

import math

import torch


def build_reference(cls, device, seed: int, **kw) -> torch.nn.Module:
    """``cls(**kw)`` on ``device`` in eval mode, weights drawn from
    ``seed``."""
    with torch.device("meta"):
        module = cls(**kw)
    module = module.to_empty(device=device)
    fill_(module, seed)
    return module.eval()


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int) -> None:
    entries = [(n, t) for n, t in module.state_dict(keep_vars=True).items()
               if t.is_floating_point()]
    dev = entries[0][1].device
    total = sum(t.numel() for _, t in entries)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=dev)
    at = 0
    for name, t in entries:
        v = z[at:at + t.numel()].view(t.shape)
        at += t.numel()
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("obj_logit_scale"):
            val = torch.full_like(v, math.log(1 / 0.07))
        elif leaf == "running_mean":
            val = 0.1 * v
        elif leaf == "running_var":
            val = 1.0 + 0.1 * v.abs()
        elif t.dim() >= 2:
            val = v / math.sqrt(t[0].numel())
        elif leaf == "bias":
            val = 0.02 * v
        else:  # LayerNorm / BatchNorm scale
            val = 1.0 + 0.02 * v
        t.copy_(val)
    for name, t in module.state_dict(keep_vars=True).items():
        if not t.is_floating_point():  # BatchNorm's num_batches_tracked
            t.zero_()

