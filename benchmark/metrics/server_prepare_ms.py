"""``server_prepare_ms.serve``: milliseconds a batch the server spent padding,
collating, narrowing to the wire format and pinning (the program's
``serve.prepare`` spans, ``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    return spans.server_ms(spans.program_spans(), "serve.prepare")
