"""``engine_fetch_ms.eval``: milliseconds a batch ``evaluate`` waited for the
packed D2H copy (the program's ``eval.fetch`` spans,
``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "eval":
        return None
    return spans.engine_ms(spans.program_spans(), "eval.fetch")
