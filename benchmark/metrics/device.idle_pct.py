"""The share of the traced window in which no operation ran on the card,
in %. Layer: device (H100). Moves fps."""


def read(ctx):
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["window_s"])
