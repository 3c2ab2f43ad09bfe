"""``server_resolve_ms.serve``: milliseconds a batch the server spent unpadding
and resolving the futures, with the clients' callbacks (the program's
``serve.resolve`` spans, ``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    return spans.server_ms(spans.program_spans(), "serve.resolve")
