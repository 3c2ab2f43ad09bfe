"""``server_fetch_ms.serve``: milliseconds a batch the server spent copying the
outputs to the host, which waits for the card (the program's ``serve.fetch``
spans, ``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    return spans.server_ms(spans.program_spans(), "serve.fetch")
