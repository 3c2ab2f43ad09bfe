"""``serve_queue_ms.serve``: milliseconds a request waited in the server's
queue, from ``submit`` until a batch took it: the median over the requests
submitted in the profiled slice (the program's ``serve.queue`` spans,
``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    return spans.queue_ms(spans.program_spans())
