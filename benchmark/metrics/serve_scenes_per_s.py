"""``serve_scenes_per_s``: scenes answered inside the window, over the
window (host clock)."""


def read(obs, name):
    if obs["kind"] != "serve":
        return None
    return obs["answered_in_window"] / obs["window_s"]
