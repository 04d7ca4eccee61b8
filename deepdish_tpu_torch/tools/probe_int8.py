"""Does int8 beat bf16 on the card, through the port's int8 contraction?

Port of the repository's tools/probe_int8.py. The reference's EdgeTPU
artifacts are full-integer quantized; the port runs its int8 contractions
(models/qgraph.py `int8_matmul`: `torch._int_mm`, cuBLASLt int8 x int8 ->
int32, widened to int64) in the w8a8 SSD and MARS and the integer
executor. This probe times them against bf16 on the shapes the framework
runs:

  matmul  a square (N, N) product, N = 4096: bf16 `x @ w` against int8
          `int8_matmul` requantized back to int8 by `>> 7` (the serving
          step's epilogue), each chained on its own output;
  conv    three 3x3 / 1x1 SAME convolutions (CONVS: MARS-like small
          channels, the SSD's 19x19x512 pointwise, a fat 40x40x256 one):
          bf16 `F.conv2d` on channels_last tensors (the JAX tool's NHWC,
          which cuDNN's NHWC kernels take as is) against the int8 path the
          port has, im2col + `int8_matmul` (models/mars_q.py `conv_i8`),
          requantized by `>> 7`. Torch has no int8 convolution on CUDA:
          this is the counterpart of the JAX tool's "int8 conv
          unsupported" branch, and the JSON names it (`int8_path`).

Inputs are ones, as in the JAX tool (the chained bf16 values overflow to
inf within a few calls: timing only). Timing: ROUNDS rounds of REPS
chained calls per leg, the legs in turns, CUDA events around each round
and a forced host read ending it (`bench.round_ms`). On the card the int8
legs are also run once on a seeded input (CHECK_ROWS rows or images at
the full width) and compared with the CPU's exact result
(`int8_card_equals_cpu`).

  python -m deepdish_tpu_torch.tools.probe_int8 [--device cuda]

Prints the JAX tool's lines, then one JSON line last: each leg's median,
min and max ms over its rounds, TFLOP/s (bf16) and TOP/s (int8) at the
median, the speedup (bf16 ms / int8 ms), and the bench's `platform` and
`device` keys. A reading above the H100's dense peak (989 TFLOP/s bf16,
1,979 TOP/s int8: flops_report.PEAKS) means the timing window is wrong:
the tool then exits 1, as it does when the card differs from the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..models.mars_q import conv_i8
from ..models.qgraph import int8_matmul, int8_weight
from . import bench
from .flops_report import PEAKS

N = 4096
# (tag, batch, hw, cin, cout, k)
CONVS = (("mars-ish", 256, 32, 32, 32, 3),
         ("ssd-pointwise", 32, 19, 512, 512, 1),
         ("fat", 32, 40, 256, 256, 3))
REPS = 32
ROUNDS = 3
CHECK_ROWS = 64            # rows of the seeded matmul check; 2 conv images
INT8_CONV_PATH = ("im2col + int8_matmul (models/mars_q.py conv_i8; torch "
                  "has no int8 convolution on CUDA)")


def requant(acc: torch.Tensor) -> torch.Tensor:
    """The JAX tool's epilogue: (acc >> 7) cast to int8 (wrapping)."""
    return (acc >> 7).to(torch.int8)


def matmul_weights(n: int):
    """(float (n, n) weight, int8 (n, n) weight), seeded as the JAX tool's
    (its float draw is jax.random's; this one numpy's)."""
    kb = np.random.RandomState(0).standard_normal((n, n)).astype(np.float32)
    ki = np.random.RandomState(0).randint(-127, 127, (n, n)).astype(np.int8)
    return kb, ki


def matmul_steps(kb, ki, dev, dtype=torch.bfloat16):
    """The two chained steps: x @ kb in `dtype`, and the int8 product
    requantized to int8."""
    wb = torch.from_numpy(kb).to(dev, dtype)
    wi = int8_weight(ki, dev)
    n = ki.shape[1]
    return (lambda x: x @ wb), (lambda x8: requant(int8_matmul(x8, wi, n)))


def conv_weights(cin: int, cout: int, k: int):
    """(float HWIO kernel, int8 HWIO kernel), seeded as the JAX tool's."""
    kb = np.random.RandomState(1).standard_normal(
        (k, k, cin, cout)).astype(np.float32)
    ki = np.random.RandomState(1).randint(
        -127, 127, (k, k, cin, cout)).astype(np.int8)
    return kb, ki


def conv_steps(kb, ki, dev, dtype=torch.bfloat16):
    """The two chained SAME stride-1 convolutions of NHWC tensors: `dtype`
    F.conv2d on the channels_last view, and the int8 im2col path
    requantized to int8."""
    k, co = kb.shape[0], kb.shape[-1]
    w = torch.from_numpy(kb).permute(3, 2, 0, 1).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    wmat = int8_weight(ki.reshape(-1, co), dev)

    def f_float(x):
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2).permute(
            0, 2, 3, 1)

    def f_int8(x8):
        return requant(conv_i8(x8, wmat, k, k, 1, co))
    return f_float, f_int8


def _card_equals_cpu(dev, make_int8, x8: np.ndarray):
    """The int8 step on the card and on the CPU on one seeded input:
    equal, exactly? None off the card."""
    if dev.type != "cuda":
        return None
    got = make_int8(dev)(torch.from_numpy(x8).to(dev)).cpu()
    want = make_int8(torch.device("cpu"))(torch.from_numpy(x8))
    return bool(torch.equal(got, want))


def _leg(dev, label, shape, flops, steps, xs, rounds, reps, equal):
    """Times the bf16 and int8 steps in turns; prints the JAX tool's lines
    and returns the leg's JSON row."""
    legs = {"bf16": (steps[0], xs[0]), "int8": (steps[1], xs[1])}
    times, _ = bench.interleaved_ms(dev, legs, rounds, reps)
    tb, ti = (float(np.median(times[k])) for k in ("bf16", "int8"))
    row = {"leg": label, "shape": shape, "flops": flops,
           **bench.spread("bf16_ms", times["bf16"]),
           **bench.spread("int8_ms", times["int8"]),
           "bf16_tflops": flops / tb / 1e9, "int8_tops": flops / ti / 1e9,
           "speedup": tb / ti, "int8_card_equals_cpu": equal}
    print(f"bf16: {tb:.3f} ms  {row['bf16_tflops']:.1f} TFLOPS", flush=True)
    print(f"int8: {ti:.3f} ms  {row['int8_tops']:.1f} TOPS  "
          f"speedup x{tb / ti:.2f}", flush=True)
    return row


def probe_matmul(dev, n, rounds, reps):
    print(f"-- square matmul {n}x{n} --", flush=True)
    kb, ki = matmul_weights(n)
    x8 = np.random.RandomState(2).randint(-127, 128, (min(CHECK_ROWS, n), n))
    equal = _card_equals_cpu(
        dev, lambda d: matmul_steps(kb, ki, d)[1], x8.astype(np.int8))
    xs = (torch.ones((n, n), dtype=torch.bfloat16, device=dev),
          torch.ones((n, n), dtype=torch.int8, device=dev))
    return _leg(dev, f"matmul {n}", [n, n, n], 2 * n ** 3,
                matmul_steps(kb, ki, dev), xs, rounds, reps, equal)


def probe_conv(dev, tag, batch, hw, cin, cout, k, rounds, reps):
    label = f"conv {tag} B{batch} {hw}x{hw}x{cin}->{cout} k{k}"
    print(f"-- {label} --", flush=True)
    kb, ki = conv_weights(cin, cout, k)
    x8 = np.random.RandomState(2).randint(-127, 128, (min(2, batch), hw, hw,
                                                      cin))
    equal = _card_equals_cpu(
        dev, lambda d: conv_steps(kb, ki, d)[1], x8.astype(np.int8))
    shape = (batch, hw, hw, cin)
    xs = (torch.ones(shape, dtype=torch.bfloat16, device=dev),
          torch.ones(shape, dtype=torch.int8, device=dev))
    row = _leg(dev, label, [batch, hw, hw, cin, cout, k],
               2 * batch * hw * hw * cin * cout * k * k,
               conv_steps(kb, ki, dev), xs, rounds, reps, equal)
    row["int8_path"] = INT8_CONV_PATH
    return row


def over_peak(rows):
    """Readings above the H100's dense peak, at each leg's fastest round."""
    out = []
    for r in rows:
        for kind, key, peak in (("bf16", "bf16_ms_min", PEAKS["bf16"]),
                                ("int8", "int8_ms_min", PEAKS["int8"])):
            rate = r["flops"] / (r[key] * 1e-3)
            if rate > peak:
                out.append(f"{r['leg']} {kind}: {rate / 1e12:.1f} T/s > "
                           f"{peak / 1e12:.0f}")
    return out


def parser():
    p = argparse.ArgumentParser(
        description="int8 against bf16 on the card: a square product and "
                    "three convolutions.")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None, *, n=N, convs=CONVS, rounds=ROUNDS, reps=REPS) -> int:
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    info = bench.device_info(dev)
    print("device:", info["device"]["name"] or "cpu", flush=True)
    with torch.inference_mode():
        rows = [probe_matmul(dev, n, rounds, reps)]
        rows += [probe_conv(dev, *c, rounds, reps) for c in convs]
    over = over_peak(rows)
    unequal = [r["leg"] for r in rows if r["int8_card_equals_cpu"] is False]
    line = {"metric": "int8 against bf16: ms a call", "legs": rows,
            "int8_card_equals_cpu": (None if dev.type != "cuda"
                                     else not unequal),
            "over_peak": over, "rounds": rounds, "reps": reps, **info}
    print(json.dumps(line), flush=True)
    return 1 if over or unequal else 0


if __name__ == "__main__":
    sys.exit(main())
