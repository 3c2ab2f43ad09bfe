"""``server_step_ms.serve``: milliseconds a batch the server spent in the eval-
step call: the host enqueueing the step's launches (the program's
``serve.step`` spans, ``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    return spans.server_ms(spans.program_spans(), "serve.step")
