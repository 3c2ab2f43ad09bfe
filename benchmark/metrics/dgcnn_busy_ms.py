"""``dgcnn_busy_ms.<path>``: device milliseconds a batch in the DGCNN: the
kernels, copies and memsets launched inside the program's ``model.dgcnn``
span (``harness/dgcnn.py``, matched by launch correlation in a trace of
every thread), over the spans in the profiled slice."""


def read(obs, name):
    tr = obs.get("trace") or {}
    d = tr.get("dgcnn")
    if obs["kind"] != name.split(".", 1)[1] or not d or not d["spans"] or d["seconds"] <= 0:
        return None
    return 1e3 * d["seconds"] / d["spans"]
