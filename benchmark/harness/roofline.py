"""Peaks of the card, and the operation and byte counts that the roofline
and MFU readers divide by them.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit):

* ``fp32_flops`` 165 TFLOP/s: the card's highest rate of products accurate
  to fp32.  The configurations compute in fp32 with TF32 off; the fastest
  fp32-accurate route is three TF32 products per fp32 product (3xTF32) at
  495 TFLOP/s, so 495 / 3.  No correct fp32 path can pass it, whichever
  kernels a later change brings.
* ``hbm_bytes_per_s`` 3.35 TB/s.

FLOPs are counted on the benchmark's plain reference (``benchmark/
reference``), never on the program, so any implementation of the same work
reads the same count: ``torch.utils.flop_counter.FlopCounterMode`` over one
scene at its own node count (its full directed graph), forward, plus the
backward for training.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

PEAKS = {
    # substring of torch.cuda.get_device_name() -> peaks
    "H100 80GB HBM3": {"fp32_flops": 495e12 / 3, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: Optional[str]) -> Optional[Dict[str, float]]:
    """The peaks of a card by its name; None for a card (or the CPU) the
    table does not hold, and the readers that need a peak then report
    nothing."""
    if not device_name:
        return None
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    return None


def segment_max_bytes(valid_edges: int, batch: int, edges: int, nodes: int, dim: int) -> int:
    """Bytes one ``vlsat::segment_max`` call must move: the valid edge rows
    (f32, ``dim`` wide) and their target indices (int32) in, the whole
    (batch, edges) bool mask in, and the (batch, nodes, dim) f32 result
    out.  Each byte once, whatever the kernel reads again."""
    return 4 * valid_edges * dim + 4 * valid_edges + batch * edges + 4 * batch * nodes * dim


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs of ``fn()`` by ``FlopCounterMode`` (matrix products and
    convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
