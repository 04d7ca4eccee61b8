"""Host syncs of the port's control flow (its `device.host_syncs`
counter) over the window, per frame. Layer: engine
(`parallel/multistream.py`). Moves fps."""


def read(ctx):
    return ctx["counters"]["host_syncs"] / ctx["frames"]
