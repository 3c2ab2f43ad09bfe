"""Profiling hooks (counterpart of ``vlsat_tpu/utils/profiling.py``).

``trace()`` records a region with ``torch.profiler`` (the host, and the
card's kernels when there is one) into a Chrome trace under
``VLSAT_PROFILE_DIR`` (or ``log_dir``), viewable in Perfetto or
``chrome://tracing``; with neither set it does nothing.  ``annotate()``
names a subregion.  ``compiled_flops`` counts the FLOPs of one call and
``peak_flops_per_sec`` gives the card's dense bf16 peak, for MFU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

# dense bf16 peaks of NVIDIA's H100 data sheet, by part
_H100_BF16 = (("nvl", 835e12), ("pcie", 756e12), ("", 989e12))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Profile the block into ``<log_dir>/trace_<pid>_<ns>.json`` and yield
    that path (None, and no profiling, without a directory)."""
    log_dir = log_dir or os.environ.get("VLSAT_PROFILE_DIR")
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named range inside a ``trace()`` (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def peak_flops_per_sec(device=None) -> float:
    """The dense bf16 peak FLOP/s of an H100 card (SXM 989, PCIe 756, NVL
    835 TFLOP/s), for MFU; ``VLSAT_PEAK_TFLOPS`` overrides it.  Raises for
    any other card: there is no default peak."""
    env = os.environ.get("VLSAT_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        raise ValueError(f"no peak FLOP/s known for {name!r}; set VLSAT_PEAK_TFLOPS")
    return next(peak for part, peak in _H100_BF16 if part in name.lower())


def compiled_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the operators it
    runs (matrix products, convolutions, attention).  Unlike XLA's cost
    analysis, which counts a ``lax.scan`` body once, this counts every
    iteration of a loop.  ``vlsat::pointnet_encode`` counts its plain
    chain's products (its formula in ``ops/kernels/pointnet_kernel.py``), so
    the fused and plain routes count alike; ``vlsat::segment_max`` has no
    products and counts 0, as the plain ``scatter_reduce`` does."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
