"""Profiling hooks and the port's spans (counterpart of
``vlsat_tpu/utils/profiling.py``).

``span(name, **attrs)`` times a block of the program: its name, start and
end (``time.perf_counter_ns``), thread, a span id, the enclosing span's id
on that thread (its parent) and small attributes (request and batch ids,
scenes, bucket, valid edges).  ``record`` adds an interval whose start the
caller stamped (``stamp``), such as a request's wait in the server's queue,
which starts on one thread and ends on another.  Records go into an
in-memory buffer of the last ``MAX_SPANS``; ``spans()`` returns them and
``clear()`` empties it.  Nothing is written on the hot path.

The one switch: spans record while a ``torch.profiler`` session is active
anywhere in the process (``torch.autograd.profiler._is_profiler_enabled``,
process-global, set by the profiler's ``start`` and ``stop``).  Off, a span
site reads that flag and returns a shared no-op context.  On, a span also
opens ``torch.profiler.record_function(name)``, so it sits in the
profiler's trace on that trace's clock wherever the profiler records its
thread: the thread that started the profiler, and every thread under
``profile_all_threads`` (whose own state reads off on the other threads).

``trace()`` records a region with ``torch.profiler`` (the host, and the
card's kernels when there is one) into a Chrome trace under
``VLSAT_PROFILE_DIR`` (or ``log_dir``), viewable in Perfetto or
``chrome://tracing``; with neither set it does nothing.  It adds the region's
spans that the profiler did not record (the threads it does not profile,
such as the server's worker) to the same trace, on its clock.
``compiled_flops`` counts the FLOPs of one call and ``peak_flops_per_sec``
gives the card's dense bf16 peak, for MFU.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
# read as a module attribute at each span site: the profiler rebinds it
import torch.autograd.profiler as _autograd_profiler

# dense bf16 peaks of NVIDIA's H100 data sheet, by part
_H100_BF16 = (("nvl", 835e12), ("pcie", 756e12), ("", 989e12))

# the buffer's bound: a 3 s slice of serving at 1,000 requests a second
# holds ~3,600 spans, an evaluation pass ~4 a batch
MAX_SPANS = 1 << 16


class Span(NamedTuple):
    """One recorded span.  ``kind``: "profiled" (a ``record_function`` in the
    profiler's own trace too), "thread" (nested on its thread, which the
    profiler does not record) or "interval" (timed across threads; no
    parent)."""
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    thread: int  # threading.get_native_id()
    id: int
    parent: Optional[int]
    attrs: Dict[str, object]
    kind: str


_buffer: deque = deque(maxlen=MAX_SPANS)  # Span fields as plain tuples
_ids = itertools.count(1)
_local = threading.local()
_anchor: Optional[Tuple[int, int]] = None  # (time.time_ns(), time.perf_counter_ns())


def spans() -> List[Span]:
    """The recorded spans, oldest first."""
    return [Span._make(t) for t in list(_buffer)]


def clear() -> None:
    """Empty the buffer; the next recorded span takes a new clock anchor."""
    global _anchor
    _buffer.clear()
    _anchor = None


def _anchored() -> None:
    global _anchor
    if _anchor is None:
        _anchor = (time.time_ns(), time.perf_counter_ns())


def _thread() -> Tuple[list, int]:
    """This thread's stack of open span ids, and its native id."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], threading.get_native_id())
        return _local.state


class _Off:
    """The span of a site while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "start", "_rf", "_profiled", "_stack",
                 "_tid")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Attributes known only inside the block."""
        self.attrs.update(attrs)

    def __enter__(self):
        _anchored()
        self._stack, self._tid = _thread()
        self.parent = self._stack[-1] if self._stack else None
        self.id = next(_ids)
        self._stack.append(self.id)
        self._profiled = torch._C._autograd._profiler_enabled()  # this thread's state
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, kind, exc, tb):
        end = time.perf_counter_ns()
        self._rf.__exit__(kind, exc, tb)
        self._stack.pop()
        if kind is not None:
            self.attrs["error"] = kind.__name__
        _buffer.append((self.name, self.start, end, self._tid, self.id, self.parent, self.attrs,
                        "profiled" if self._profiled else "thread"))
        return False


def span(name: str, **attrs):
    """A context that records the block as a span while a profiler session
    is active, and does nothing otherwise.  The context's ``set(**attrs)``
    adds attributes; a block that raises gets ``error`` (the exception's
    type name)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def stamp() -> Optional[int]:
    """``time.perf_counter_ns()`` while spans record, else None: the start
    of a later ``record``."""
    return time.perf_counter_ns() if _autograd_profiler._is_profiler_enabled else None


def record(name: str, start_ns: Optional[int], **attrs) -> None:
    """Record an interval from ``start_ns`` (a ``stamp``) to now, or nothing
    when ``start_ns`` is None."""
    if start_ns is None:
        return
    end = time.perf_counter_ns()
    _anchored()
    _buffer.append((name, start_ns, end, _thread()[1], next(_ids), None, attrs, "interval"))


def trace_us(t_ns: int, base_ns: int) -> float:
    """A ``perf_counter_ns`` time on the clock of a Chrome trace from
    ``torch.profiler`` (microseconds of Unix time less the trace's
    ``baseTimeNanoseconds``)."""
    unix, perf = _anchor
    return (unix + t_ns - perf - base_ns) / 1e3


def _write_spans(path: str, since_ns: int) -> None:
    """Add the spans since ``since_ns`` that the profiler did not record to
    the Chrome trace at ``path``: nested ones as complete events on their
    thread, intervals as async events."""
    todo = [s for s in spans() if s.kind != "profiled" and s.start_ns >= since_ns]
    if not todo:
        return
    with open(path) as f:
        doc = json.load(f)
    base, pid = int(doc.get("baseTimeNanoseconds", 0)), os.getpid()
    names = {t.native_id: t.name for t in threading.enumerate()}
    events = doc["traceEvents"]
    for tid in sorted({s.thread for s in todo}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": names.get(tid, f"thread {tid}")}})
    for s in todo:
        ts = trace_us(s.start_ns, base)
        args = dict(s.attrs, span=s.id, parent=s.parent)
        ev = {"name": s.name, "cat": "span", "pid": pid, "tid": s.thread, "args": args}
        if s.kind == "thread":
            events.append(dict(ev, ph="X", ts=ts, dur=(s.end_ns - s.start_ns) / 1e3))
        else:
            events.append(dict(ev, ph="b", id=s.id, ts=ts))
            events.append(dict(ev, ph="e", id=s.id, ts=trace_us(s.end_ns, base)))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Profile the block into ``<log_dir>/trace_<pid>_<ns>.json``, with the
    block's spans, and yield that path (None, and no profiling, without a
    directory)."""
    global _anchor
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
        _anchor = (time.time_ns(), time.perf_counter_ns())
        since = _anchor[1]
        yield path
    prof.export_chrome_trace(path)
    _write_spans(path, since)


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
