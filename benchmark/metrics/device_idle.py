"""``device_idle.<path>`` (%): the share of the profiled slice in which no
kernel, copy or memset ran on the card (``torch.profiler``)."""


def read(obs, name):
    tr = obs.get("trace")
    if obs["kind"] != name.split(".", 1)[1] or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
