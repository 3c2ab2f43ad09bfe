"""``segment_max_roofline.<path>`` (%): the ``vlsat::segment_max`` kernel's
share of its bound.  Its time a call is the profiled kernel time over its
calls; its bound a call is the bytes it must move (``harness/roofline.py``
``segment_max_bytes``, from the shapes and valid edges of the batches that
started in the slice) over the card's HBM bandwidth."""

from benchmark.harness.roofline import segment_max_bytes


def read(obs, name):
    tr, peaks = obs.get("trace"), obs.get("peaks")
    batches = obs.get("traced_batches")
    if obs["kind"] != name.split(".", 1)[1] or not tr or not peaks or not batches:
        return None
    rows = [(t, n) for k, (t, n) in tr["kernels"].items() if "segment_max" in k]
    seconds, calls = sum(t for t, _ in rows), sum(n for _, n in rows)
    if not calls or seconds <= 0:
        return None
    d = obs["segment_max_dim"]
    mean_bytes = sum(segment_max_bytes(v, b, e, n, d) for v, b, n, e in batches) / len(batches)
    return 100.0 * (mean_bytes / peaks["hbm_bytes_per_s"]) / (seconds / calls)
