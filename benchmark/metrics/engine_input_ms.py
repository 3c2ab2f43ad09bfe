"""``engine_input_ms.eval``: milliseconds a batch ``evaluate`` waited for the
loader's next item (the program's ``eval.input`` spans,
``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "eval":
        return None
    return spans.engine_ms(spans.program_spans(), "eval.input")
