"""The program's own spans (``vlsat_tpu_torch.utils.profiling.spans()``), as
the ``program_span`` metrics read them.

The program records spans only while a ``torch.profiler`` session is active
in the process, so in a traced run its buffer holds the profiled slice, and
in an untraced run nothing.  Each function takes the spans (``Span`` tuples:
``name``, ``start_ns``, ``end_ns``, ``thread``, ``id``, ``parent``,
``attrs``, ``kind``) and returns milliseconds, or None where it finds
nothing to read.
"""

from __future__ import annotations

import statistics
from typing import Optional, Sequence


def program_spans() -> list:
    """The program's recorded spans; empty where the program records none
    (a version without ``utils.profiling.spans``)."""
    from vlsat_tpu_torch.utils import profiling

    get = getattr(profiling, "spans", None)
    return list(get()) if get is not None else []


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def queue_ms(spans: Sequence) -> Optional[float]:
    """Median milliseconds a request waited in the server's queue
    (``serve.queue``)."""
    waits = [_ms(s) for s in spans if s.name == "serve.queue"]
    return statistics.median(waits) if waits else None


def server_ms(spans: Sequence, name: str) -> Optional[float]:
    """Milliseconds a batch in the server's child span ``name`` of
    ``serve.batch``, over the batches whose ``serve.batch`` was recorded."""
    batches = {s.id for s in spans if s.name == "serve.batch"}
    if not batches:
        return None
    return sum(_ms(s) for s in spans if s.name == name and s.parent in batches) / len(batches)


def engine_ms(spans: Sequence, name: str) -> Optional[float]:
    """Milliseconds a batch in the evaluation engine's span ``name``, over
    the batches that its ``eval.step`` spans ran (K a group)."""
    batches = sum(s.attrs.get("batches", 1) for s in spans if s.name == "eval.step")
    if not batches:
        return None
    return sum(_ms(s) for s in spans if s.name == name) / batches
