"""``engine_host_ms.eval``: host milliseconds a batch that ``evaluate``
spent outside its eval-step calls (preparing, gathering rows, ranking,
copying and assembling metrics), over the window's passes outside the
profiled slice: the window's wall less the step calls' spans, over the
batches.  The spans come from the benchmark's wrapper of the step."""


def read(obs, name):
    if obs["kind"] != "eval" or not obs.get("host_spans"):
        return None
    wall, in_steps, calls = obs["host_spans"]
    return 1e3 * (wall - in_steps) / calls if calls else None
