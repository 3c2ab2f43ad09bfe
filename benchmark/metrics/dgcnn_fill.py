"""``dgcnn_fill.serve`` (%): the valid instances of the server's batches
over their instance slots (B * N, what the DGCNN computes): the program's
counters of each batch, which it carries as the ``instances`` /
``instance_slots`` attributes of its ``serve.step`` spans, over the batches
of the profiled slice (``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    steps = [s.attrs for s in spans.program_spans()
             if s.name == "serve.step" and "instance_slots" in s.attrs]
    slots = sum(a["instance_slots"] for a in steps)
    if not slots:
        return None
    return 100.0 * sum(a["instances"] for a in steps) / slots
