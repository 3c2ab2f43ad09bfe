"""``union_busy_ms.<path>``: device milliseconds a batch in SGPN's relation
encoder: the kernels, copies and memsets launched inside the program's
``model.union`` span (``harness/union.py`` ``UnionProfile``, matched by
launch correlation in a trace of every thread), over the spans in the
profiled slice."""


def read(obs, name):
    tr = obs.get("trace") or {}
    u = tr.get("union")
    if obs["kind"] != name.split(".", 1)[1] or not u or not u["spans"] or u["seconds"] <= 0:
        return None
    return 1e3 * u["seconds"] / u["spans"]
