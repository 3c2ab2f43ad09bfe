"""``setup_s``: seconds from the process's start to the first timed
request, step or pass (host clock): building the model, loading the
weights, making the traffic, placing data on the card and warming up every
shape the cell uses."""


def read(obs, name):
    return obs["setup_s"]
