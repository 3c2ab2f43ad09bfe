"""Per-bucket batch-size selection for the packed and resident loaders
(counterpart of ``vlsat_tpu/data/bucket_batch.py``, the same mapping rules).

Eval batch size is pure throughput: eval has no cross-scene coupling (BN
runs on running statistics, attention is scene-masked), so metrics are equal
at any B.  The loaders therefore take ``batch_size`` as an int (one size for
every bucket) or a {bucket: B} mapping resolved per bucket here.  Train batch
size is not pure throughput (it sets the gradient noise and the
batch-multiplicative schedule), so training keeps one ``Batch_Size``.

``DEFAULT_EVAL_BATCH`` is the port's own table, from the ``data_feed`` phase
of ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W: buckets 8 and 12
hold the fastest B of {16, 32, 64} over the resident grouped path, B=64 at
12; at 8, B=32 and 64 tie within the runs' spread and the smaller batch is
kept, the JAX table's rule for near-ties (PERF.md).  The JAX package's
table holds a TPU's winners (B=64 at bucket 48, twice the batch whose
evaluation peaks at 15.7 GiB on the card) and is not copied.  Every other
bucket holds 32, the batch the smoke run evaluates with, not yet measured
on the card.
"""

from __future__ import annotations

from typing import Mapping, Union

BatchSpec = Union[int, Mapping[int, int]]

DEFAULT_EVAL_BATCH: Mapping[int, int] = {
    4: 32,   # not yet measured on the card
    8: 32,   # measured on the card: 32 and 64 a near-tie, 16 slowest
    12: 64,  # measured on the card: 16 < 32 < 64 scenes/s
    16: 32,  # not yet measured on the card
    24: 32,  # not yet measured on the card
    32: 32,  # not yet measured on the card
    48: 32,  # not yet measured on the card
    64: 32,  # not yet measured on the card
}


def resolve_batch(batch_size: BatchSpec, bucket: int) -> int:
    """int -> itself; mapping -> the exact bucket, else the value at the
    smallest mapped bucket above it (conservative for memory), else the
    largest mapped bucket's value."""
    if isinstance(batch_size, int):
        return batch_size
    if bucket in batch_size:
        return int(batch_size[bucket])
    above = [k for k in batch_size if k > bucket]
    key = min(above) if above else max(batch_size)
    return int(batch_size[key])
