"""Probe: packing 4 crops into the channel axis of MARS's narrow convs.

Port of the repository's tools/probe_grouped_conv.py. MARS's 32- and
64-output-channel 3x3 convolutions give the tensor cores narrow products
(MARS at batch 1024 runs at a few percent of the bf16 peak). Padding the
channels buys width with wasted FLOPs; this probes the alternative that
wastes none: pack G = 4 crops along the channel axis and run ONE conv with
groups = 4 whose kernel is the shared c -> c kernel tiled 4x on the
output axis (per crop the same result; the conv sees 4c channels). Three
legs per shape (SHAPES: MARS's stages at encode capacity 32 x chunk 32 =
1024 crops, and 256 crops), each a chain of --layers convs, timed in
turns:

  base   (B, h, w, c) -> c;
  pack   (B/4, h, w, 4c) -> 4c, groups = 4, the 3x3 kernel tiled 4x;
  dense  (B/4, h, w, 4c) -> 4c, groups = 1: the full-FLOPs reference.

All in bf16 through `F.conv2d`, SAME padding, every tensor and kernel
channels_last (the JAX tool's NHWC, which cuDNN's NHWC kernels take as
is). Inputs and kernels are seeded normal draws; the packed input holds
the base input's crops (crop i * 4 + g in channels g*c ... (g+1)*c), and
one packed layer must equal the base layer per crop within the bound on
reordering a float32 sum (`packed_tolerance`, as ops.dsconv's
`reorder_tolerance`): `packed_identity`. Timing: --rounds rounds of --reps
calls per leg, CUDA events around each round and a forced host read
ending it (`bench.round_ms`).

  python -m deepdish_tpu_torch.tools.probe_grouped_conv [--rounds 4] \
      [--reps 32] [--layers 6] [--device cuda]

Prints the JAX tool's table, then one JSON line last: per shape each leg's
median, min and max ms a chain over its rounds, TFLOP/s of the base
chain's FLOPs at the median (the JAX tool's figure), the ratio against
base, the identity's worst excess over its bound, and the bench's
`platform` and `device` keys. A leg whose own work would run above the
H100's dense bf16 peak, or a failed identity, exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from . import bench
from .flops_report import PEAKS

# (label, B, h, w, c): MARS stages at 1024 crops a dispatch: post-pool
# 63x31@32, mid 32x16@64; and 256 crops
SHAPES = (("mars 63x31 c32 B1024", 1024, 63, 31, 32),
          ("mars 32x16 c64 B1024", 1024, 32, 16, 64),
          ("mars 63x31 c32 B256", 256, 63, 31, 32))
G = 4


def to_oihw(k_hwio: np.ndarray, dev, dtype) -> torch.Tensor:
    return torch.from_numpy(k_hwio).permute(3, 2, 0, 1).to(dev, dtype) \
        .contiguous(memory_format=torch.channels_last)


def nchw(x_nhwc: np.ndarray, dev, dtype) -> torch.Tensor:
    """An NHWC array as a channels_last NCHW tensor (no copy of the
    layout)."""
    return torch.from_numpy(x_nhwc).to(dev, dtype).permute(0, 3, 1, 2)


def pack(x_nhwc: np.ndarray, g: int = G) -> np.ndarray:
    """(B, h, w, c) -> (B/g, h, w, g*c): crop i*g + j in channels j*c ...
    (j+1)*c of packed crop i."""
    b, h, w, c = x_nhwc.shape
    return x_nhwc.reshape(b // g, g, h, w, c).transpose(0, 2, 3, 1, 4) \
        .reshape(b // g, h, w, g * c)


def unpack(y_nchw: torch.Tensor, g: int = G) -> torch.Tensor:
    """The inverse of `pack` on a conv output (B/g, g*c, h, w) -> (B, c,
    h, w)."""
    n, gc, h, w = y_nchw.shape
    return y_nchw.reshape(n, g, gc // g, h, w).reshape(n * g, gc // g, h, w)


def inputs(b, h, w, c):
    """Seeded draws: base input (B, h, w, c), 3x3 c -> c kernel, dense 3x3
    4c -> 4c kernel; float32 numpy, NHWC / HWIO."""
    xb = np.random.RandomState(1).standard_normal((b, h, w, c))
    kb = np.random.RandomState(0).standard_normal((3, 3, c, c))
    kd = np.random.RandomState(2).standard_normal((3, 3, G * c, G * c))
    return xb.astype(np.float32), kb.astype(np.float32), kd.astype(np.float32)


def conv(x, k, groups):
    return F.conv2d(x, k, padding=1, groups=groups)


def chain(x, k, groups, n):
    for _ in range(n):
        x = conv(x, k, groups)
    return x


def packed_tolerance(x, k, a, b):
    """Per element, how far two results `a`, `b` of conv(x, k) may be
    apart when they differ only in the order of the float32 sum of the
    n = 9 * Cin products: each order is within g * S of the exact sum
    (S = conv(|x|, |k|), g = n u / (1 - n u), u = 2^-24: Higham's bound,
    any order), and the rounding to the output dtype adds at most one ulp
    at the larger of |a|, |b|."""
    n = 9 * x.shape[1]
    u = 2.0 ** -24
    g = n * u / (1 - n * u)
    s = conv(x.float().abs(), k.float().abs(), 1)
    larger = torch.maximum(a.float().abs(), b.float().abs())
    ulp = torch.finfo(a.dtype).eps * larger
    return 2 * g * s + ulp


def packed_identity(xb, kb, dev, dtype=torch.bfloat16):
    """One packed layer against one base layer on the same crops: (worst
    |packed - base| - bound, worst |packed - base|); the first <= 0 means
    the identity holds."""
    x = nchw(xb, dev, dtype)
    k = to_oihw(kb, dev, dtype)
    base = conv(x, k, 1)
    kp = to_oihw(np.concatenate([kb] * G, axis=-1), dev, dtype)
    packed = unpack(conv(nchw(pack(xb), dev, dtype), kp, G))
    diff = (packed.float() - base.float()).abs()
    bound = packed_tolerance(x, k, packed, base)
    return float((diff - bound).max()), float(diff.max())


def probe(dev, label, b, h, w, c, rounds, reps, layers, dtype=torch.bfloat16):
    xb, kb, kd = inputs(b, h, w, c)
    excess, worst = packed_identity(xb, kb, dev, dtype)
    xp = nchw(pack(xb), dev, dtype)
    legs = {f"base  c{c} fgc1": (nchw(xb, dev, dtype), to_oihw(kb, dev, dtype),
                                 1, 1),
            f"pack c{G * c} fgc{G}": (xp, to_oihw(np.concatenate(
                [kb] * G, axis=-1), dev, dtype), G, 1),
            f"dense c{G * c} fgc1": (xp, to_oihw(kd, dev, dtype), 1, G)}
    times, _ = bench.interleaved_ms(
        dev, {n: (lambda _, a=a: chain(a[0], a[1], a[2], layers), None)
              for n, a in legs.items()}, rounds, reps)
    flops = 2 * b * h * w * c * c * 9 * layers
    print(f"\n{label}  ({flops / 1e9:.2f} GFLOP/chain)", flush=True)
    base = float(np.median(times[f"base  c{c} fgc1"]))
    rows, over = {}, []
    for name, ms in times.items():
        t = float(np.median(ms))
        rows[name] = {**bench.spread("ms", ms), "tflops": flops / t / 1e9,
                      "x_vs_base": base / t}
        own = flops * legs[name][3] / (min(ms) * 1e-3)
        if own > PEAKS["bf16"]:
            over.append(f"{label} {name}: {own / 1e12:.1f} TFLOP/s")
        print(f"  {name:18s} {t:7.3f} ms  {flops / t / 1e9:6.1f} TFLOPS"
              f"  x{base / t:.2f} vs base", flush=True)
    print(f"  packed == base per crop: worst |diff| {worst:.3e}, excess over "
          f"the reorder bound {excess:.3e}", flush=True)
    return {"shape": label, "batch": b, "h": h, "w": w, "c": c,
            "gflop_per_chain": flops / 1e9, "legs": rows,
            "packed_identity_excess": excess,
            "packed_identity_max_abs": worst}, over


def parser():
    p = argparse.ArgumentParser(
        description="Grouped-conv channel packing for MARS's narrow convs.")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--layers", type=int, default=6,
                   help="chain length (amortizes dispatch; MARS has ~6 "
                        "convs per channel stage)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None, *, shapes=SHAPES) -> int:
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    info = bench.device_info(dev)
    print("device:", info["device"]["name"] or "cpu", flush=True)
    rows, over = [], []
    with torch.inference_mode():
        for s in shapes:
            row, o = probe(dev, *s, args.rounds, args.reps, args.layers)
            rows.append(row)
            over += o
    failed = [r["shape"] for r in rows if r["packed_identity_excess"] > 0]
    line = {"metric": "grouped-conv packing: ms a chain", "shapes": rows,
            "packed_identity_holds": not failed, "over_peak": over,
            "memory_format": "channels_last", "dtype": "bf16",
            "rounds": args.rounds, "reps": args.reps, "layers": args.layers,
            **info}
    print(json.dumps(line), flush=True)
    return 1 if over or failed else 0


if __name__ == "__main__":
    sys.exit(main())
