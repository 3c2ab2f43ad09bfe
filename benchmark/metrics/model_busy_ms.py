"""``model_busy_ms.<path>``: device-busy milliseconds (the union of kernel,
copy and memset intervals in the profiled slice) per batch or train step
that started in the slice."""


def read(obs, name):
    tr = obs.get("trace")
    calls = len(obs.get("traced_batches") or ())
    if obs["kind"] != name.split(".", 1)[1] or not tr or tr["busy_s"] <= 0 or not calls:
        return None
    return 1e3 * tr["busy_s"] / calls
