"""Device time of the port's LSAP kernel (`lsap_kernel`, found by name in
the trace) over the window, per launch of it (the port's
`kernels.lsap.launches` counter), in us. Layer: LSAP kernel
(`csrc/lsap.cu`, `kernels/lsap.py`). Moves fps. Nothing to read in a
window without launches."""


def read(ctx):
    launches = ctx["counters"]["lsap_launches"]
    s = sum(v for n, v in ctx["trace"]["kernels"].items()
            if "lsap_kernel" in n)
    return s * 1e6 / launches if launches and s > 0 else None
