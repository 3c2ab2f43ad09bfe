"""``union_h2d_mb.serve``: megabytes (1e6 bytes) of union point clouds the
server shipped to the card a batch: the program's ``union_bytes`` counter,
which it carries on each ``serve.prepare`` span, over the batches of the
profiled slice (``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    shipped = [s.attrs["union_bytes"] for s in spans.program_spans()
               if s.name == "serve.prepare" and "union_bytes" in s.attrs]
    if not shipped:
        return None
    return sum(shipped) / len(shipped) / 1e6
