"""``dgcnn_roofline.<path>`` (%): the DGCNN's share of its bound.  Its bound
a batch is the factored FLOPs (``harness/dgcnn.py``
``dgcnn_factored_flops``) of the batch's valid instances, the mean over
the batches whose step started in the profiled slice, at the card's
fp32-accurate peak (``harness/roofline.py``); its time a batch is
``dgcnn_busy_ms``'s."""


def read(obs, name):
    tr, peaks = obs.get("trace") or {}, obs.get("peaks")
    d, batches = tr.get("dgcnn"), obs.get("traced_batches")
    if (obs["kind"] != name.split(".", 1)[1] or not d or not d["spans"] or d["seconds"] <= 0
            or not peaks or not batches or not obs.get("dgcnn_flops_per_instance")):
        return None
    instances = sum(b[0] for b in batches) / len(batches)
    bound_s = instances * obs["dgcnn_flops_per_instance"] / peaks["fp32_flops"]
    return 100.0 * bound_s / (d["seconds"] / d["spans"])
