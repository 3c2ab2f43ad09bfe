"""``eval_scenes_per_s``: scenes whose metrics ``evaluate`` returned in the
window's whole passes over the split, over the time those passes took (host
clock, metric assembly included)."""


def read(obs, name):
    if obs["kind"] != "eval":
        return None
    return obs["scenes"] / obs["window_s"]
