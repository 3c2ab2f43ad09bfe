"""``engine_step_ms.eval``: milliseconds a batch ``evaluate`` spent in the eval
step, the rank functions, the pack and the D2H enqueue (the program's
``eval.step`` spans, ``benchmark/harness/spans.py``)."""

from benchmark.harness import spans


def read(obs, name):
    if obs["kind"] != "eval":
        return None
    return spans.engine_ms(spans.program_spans(), "eval.step")
