"""LSAP kernel launches (the port's `kernels.lsap.launches` counter) over
the window, per frame. Layer: LSAP kernel (`csrc/lsap.cu`,
`kernels/lsap.py`). Moves fps."""


def read(ctx):
    return ctx["counters"]["lsap_launches"] / ctx["frames"]
