"""Open-loop serving in on/off bursts: ``serve_open_loop``'s server, pool,
window, check and metrics, with arrivals that come in bursts of
``burst_on_s`` seconds followed by ``burst_off_s`` seconds with none.

``rate`` is the mean over a whole cycle; inside a burst requests arrive at
``rate * (burst_on_s + burst_off_s) / burst_on_s``, each burst with the
quantile gaps of ``serve_open_loop.arrivals`` in an order drawn from the
seed and the burst's index, so every seed offers the same number of
requests in every burst, with the same gaps in another order.  Only whole
cycles fit in the window; what is left of it at the end is quiet, so the
last burst drains inside the window.  The deadline and batching policy
meet a queue that fills at several times the mean rate and then empties.
"""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.harness import core
from benchmark.traffic import serve_open_loop as base

make_pool = base.make_pool
sampled = base.sampled
compare = base.compare
steady = base.arrivals


def arrivals(rate: float, seconds: float, seed: int, on_s: float, off_s: float) -> np.ndarray:
    """Due times (s from the window's start) of the requests offered."""
    cycle = on_s + off_s
    peak = rate * cycle / on_s
    due = [c * cycle + steady(peak, on_s, int(np.random.SeedSequence([seed, c])
                                               .generate_state(1)[0]))
           for c in range(int(seconds / cycle + 1e-9))]
    return np.concatenate(due) if due else np.zeros(0)


@contextlib.contextmanager
def bursts(params: dict):
    """``serve_open_loop``'s window offered with ``arrivals`` in the place
    of its own (its ``offer`` reads ``arrivals`` from its module)."""
    base.arrivals = lambda rate, seconds, seed: arrivals(
        rate, seconds, seed, params["burst_on_s"], params["burst_off_s"])
    try:
        yield
    finally:
        base.arrivals = steady


class Session(base.Session):
    """``serve_open_loop.Session`` offering bursts (the knee sweep's entry)."""

    def offer(self, *args, **kwargs) -> dict:
        with bursts(self.ctx.params):
            return super().offer(*args, **kwargs)


def run(ctx: core.Context) -> dict:
    with bursts(ctx.params):
        return base.run(ctx)
