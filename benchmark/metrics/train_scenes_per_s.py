"""``train_scenes_per_s``: scenes trained in the window over the window
(host clock); the window closes when the last step's loss is on the host,
so it holds the device's work."""


def read(obs, name):
    if obs["kind"] != "train":
        return None
    return obs["scenes"] / obs["window_s"]
