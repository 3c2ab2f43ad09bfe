"""``step_host_ms.train``: host milliseconds a train step spent inside the
step call (forward and backward enqueue, the optimizer), from the
benchmark's span around each call, over the steps outside the profiled
slice."""


def read(obs, name):
    if obs["kind"] != "train" or not obs.get("host_spans"):
        return None
    _, in_steps, calls = obs["host_spans"]
    return 1e3 * in_steps / calls if calls else None
