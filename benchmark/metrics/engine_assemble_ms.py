"""``engine_assemble_ms.eval``: milliseconds a batch ``evaluate`` spent
unpacking and assembling the metrics on the host (the program's
``eval.assemble`` spans, ``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "eval":
        return None
    return spans.engine_ms(spans.program_spans(), "eval.assemble")
