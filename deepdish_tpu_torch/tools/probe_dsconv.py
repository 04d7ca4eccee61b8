"""Probe: the fused depthwise-separable CUDA kernel against cuDNN's 2-conv
composition.

Port of tools/probe_dsconv.py. `ops.dsconv.fused_dsconv` runs depthwise
3x3 + BN + ReLU6 + pointwise 1x1 + BN + ReLU6 as one hand-written kernel
with the intermediate in shared memory; this times it against the model's
lowering (`ops.dsconv.dsconv_reference`: grouped conv -> BN -> relu6 -> 1x1
conv -> BN -> relu6, cuDNN in bf16 with TF32 off) at the nine MobileNet-300
stage shapes, interleaved per timing round, each round ending in a device
synchronise.

Run on the card:  python -m deepdish_tpu_torch.tools.probe_dsconv
                  [--rounds 4] [--reps 16] [--batch 32] [--layers 6]
                  [--stages ds1,ds13] [--device cuda]
`--device cpu` runs both legs through their plain PyTorch versions (a
check of the entry point, not a measurement of the card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.dsconv import dsconv_reference, fused_dsconv

# MobileNetV1-300 depthwise-separable stages: (label, H, W, Cin, Cout, s)
STAGES = [
    ("ds1  150^2  32-> 64 s1", 150, 150, 32, 64, 1),
    ("ds2  150^2  64->128 s2", 150, 150, 64, 128, 2),
    ("ds3   75^2 128->128 s1", 75, 75, 128, 128, 1),
    ("ds4   75^2 128->256 s2", 75, 75, 128, 256, 2),
    ("ds5   38^2 256->256 s1", 38, 38, 256, 256, 1),
    ("ds6   38^2 256->512 s2", 38, 38, 256, 512, 2),
    ("ds7   19^2 512->512 s1", 19, 19, 512, 512, 1),
    ("ds12  19^2 512->1024 s2", 19, 19, 512, 1024, 2),
    ("ds13  10^2 1024->1024 s1", 10, 10, 1024, 1024, 1),
]

LIBRARY, KERNEL = "cudnn 2-conv", "cuda fused"


def block_weights(rng, cin, cout, device, dtype=torch.bfloat16):
    """One block's (dw_k, dw_scale, dw_bias, pw_k, pw_scale, pw_bias), drawn
    from `rng` in the JAX probe's order."""
    def f(*s):
        return torch.as_tensor(rng.standard_normal(s) * 0.1).to(device, dtype)

    def v(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)
    return (f(3, 3, cin), v(rng.random(cin) + 0.5),
            v(rng.standard_normal(cin) * 0.1), f(cin, cout),
            v(rng.random(cout) + 0.5), v(rng.standard_normal(cout) * 0.1))


def make_chain(block, stride, chainable):
    """One application of `block` per weight set in a dispatch (distinct
    weights each): sequential chaining when Cin == Cout and stride 1, else
    independent applications summed. Each intermediate is dropped as soon as
    the next one exists."""
    def chain(x, ws):
        if chainable:
            for w in ws:
                x = block(x, *w, stride)
            return x
        acc = None
        for w in ws:
            y = block(x, *w, stride)
            acc = y if acc is None else acc + y
        return acc
    return chain


def timed_interleaved(legs, reps, rounds, device):
    """legs: {name: (fn, args)}. Warm all, then interleave rounds; the
    minimum per leg of (time of `reps` calls ending in a synchronise) /
    reps, in seconds."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for fn, a in legs.values():
        fn(*a)
    sync()
    best = {k: float("inf") for k in legs}
    for _ in range(rounds):
        for name, (fn, a) in legs.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*a)
            sync()
            best[name] = min(best[name], (time.perf_counter() - t0) / reps)
    return best


def main(argv=None):
    """Runs the probe; returns one dict per stage run (label, shape, GFLOP,
    maxdiff of the chains, and each leg's ms per dispatch)."""
    ap = argparse.ArgumentParser(
        prog="python -m deepdish_tpu_torch.tools.probe_dsconv")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--layers", type=int, default=6,
                    help="blocks per dispatch (amortizes launch overhead)")
    ap.add_argument("--stages", type=str, default="",
                    help="comma-separated stage prefixes to run (default all)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          flush=True)
    rng = np.random.default_rng(0)
    want = [s for s in args.stages.split(",") if s]

    results = []
    tot_ref = tot_fused = 0.0
    for label, h, w, cin, cout, s in STAGES:
        if want and not any(label.startswith(p) for p in want):
            continue
        chainable = (s == 1 and cin == cout)
        x = torch.as_tensor(rng.standard_normal((args.batch, h, w, cin)) * 0.1
                            ).to(dev, torch.bfloat16)
        ws = [block_weights(rng, cin, cout, dev) for _ in range(args.layers)]
        ref_fn = make_chain(dsconv_reference, s, chainable)
        fus_fn = make_chain(fused_dsconv, s, chainable)
        # numeric sanity on the whole chain before timing (bf16 chain drift)
        d = float((ref_fn(x, ws).float() - fus_fn(x, ws).float()).abs().max())
        legs = {LIBRARY: (ref_fn, (x, ws)), KERNEL: (fus_fn, (x, ws))}
        best = timed_interleaved(legs, args.reps, args.rounds, dev)
        ho, wo = -(-h // s), -(-w // s)
        gflop = 2 * args.batch * args.layers * (
            ho * wo * cin * 9 + ho * wo * cin * cout) / 1e9
        r, f = best[LIBRARY], best[KERNEL]
        tot_ref += r
        tot_fused += f
        kind = "chain" if chainable else "sum"
        print(f"{label}  ({gflop:.2f} GFLOP/{kind}-{args.layers})"
              f"  maxdiff {d:.4f}")
        for name, t in best.items():
            print(f"  {name:13s} {t*1e3:8.3f} ms  "
                  f"{gflop/t/1e3:6.1f} TFLOPS  x{r/t:.2f} vs cudnn")
        results.append({"label": label, "h": h, "w": w, "cin": cin,
                        "cout": cout, "stride": s, "batch": args.batch,
                        "layers": args.layers, "kind": kind, "gflop": gflop,
                        "maxdiff": d, "library_ms": r * 1e3,
                        "kernel_ms": f * 1e3})
    if tot_ref:
        print(f"\nsum over stages: cudnn {tot_ref*1e3:.3f} ms, "
              f"fused {tot_fused*1e3:.3f} ms, x{tot_ref/tot_fused:.2f}")
    return results


if __name__ == "__main__":
    main()
