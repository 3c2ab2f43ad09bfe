"""``server_batch_fill.serve`` (%): how full the server's batches were over
the window, from its own counters (``BatchedServer.stats``): scenes a batch
over ``max_batch``."""


def read(obs, name):
    if obs["kind"] != name.split(".", 1)[1] or not obs.get("batches"):
        return None
    return 100.0 * obs["fill"]
