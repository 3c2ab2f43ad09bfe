"""``mfu.<path>`` (%): the FLOPs of the real scenes the path finished in the
profiled slice (unpadded, each at its own node count, counted on the plain
reference: forward, plus backward for training) over the slice's length
times the card's fp32-accurate peak (``harness/roofline.py``)."""


def read(obs, name):
    tr, peaks = obs.get("trace"), obs.get("peaks")
    if (obs["kind"] != name.split(".", 1)[1] or not tr or not peaks
            or not obs.get("traced_flops")):
        return None
    return 100.0 * obs["traced_flops"] / (tr["window_s"] * peaks["fp32_flops"])
