"""MARS channel-width probe: does buying tensor-core width with wasted
FLOPs move MARS's time on the card?

Port of the repository's tools/profile_mars_width.py. MARS's 32- and
64-output-channel convolutions give the tensor cores narrow products.
This times the stock network against variants whose stages are widened
(random init: timing only; a zero-padded copy of real weights would run
the same kernels):

  stock  32 / 64 / 128 channels (MarsNet's widths);
  pad2   64 / 128 / 256;
  pad4   128 / 256 / 512.

`Wide(stage1, stage2, stage3)` is MarsNet (models/mars.py) with those
widths: the same modules, names and forward, `fc1` taking 16 * 8 * stage3
inputs. Wide(32, 64, 128) loads a MarsNet state dict and gives MarsNet's
output: the tool checks that on its input (`wide_equals_marsnet`). Each
variant runs in bf16 at --batch (256) seeded 128x64 patches; ROUNDS rounds
of --reps calls per variant, the variants in turns, CUDA events around
each round and a forced host read ending it (`bench.round_ms`).

  python -m deepdish_tpu_torch.tools.profile_mars_width [--batch 256] \
      [--reps 32] [--device cuda]

Prints ms a batch and us a crop per variant and each variant against
stock, then one JSON line last: each variant's median, min and max ms a
batch over its rounds, us a crop and the ratio at the median, and the
bench's `platform` and `device` keys. Exits 1 when Wide(32, 64, 128)
differs from MarsNet.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
from torch import nn

from ..models.layers import BatchNorm, SameConv2d
from ..models.mars import FEATURE_DIM, MarsNet, _ResidualBlock
from . import bench

ROUNDS = 3
VARIANTS = (("stock 32/64/128", (32, 64, 128)),
            ("pad2  64/128/256", (64, 128, 256)),
            ("pad4  128/256/512", (128, 256, 512)))


class Wide(MarsNet):
    """MarsNet with stage widths (stage1, stage2, stage3); stock = (32, 64,
    128). A width-increasing block doubles its input, so stage2 must be 2 x
    stage1 and stage3 2 x stage2 (the multipliers probed here)."""

    def __init__(self, stage1: int = 32, stage2: int = 64,
                 stage3: int = 128):
        if (stage2, stage3) != (2 * stage1, 2 * stage2):
            raise ValueError(f"widths ({stage1}, {stage2}, {stage3}) are not "
                             "(c, 2c, 4c)")
        nn.Module.__init__(self)
        self.conv1_1 = SameConv2d(3, stage1, 3)
        self.conv1_1_bn = BatchNorm(stage1)
        self.conv1_2 = SameConv2d(stage1, stage1, 3)
        self.conv1_2_bn = BatchNorm(stage1)
        self.conv2_1 = _ResidualBlock(stage1, is_first=True)
        self.conv2_3 = _ResidualBlock(stage1)
        self.conv3_1 = _ResidualBlock(stage1, increase_dim=True)
        self.conv3_3 = _ResidualBlock(stage2)
        self.conv4_1 = _ResidualBlock(stage2, increase_dim=True)
        self.conv4_3 = _ResidualBlock(stage3)
        self.fc1 = nn.Linear(16 * 8 * stage3, FEATURE_DIM, bias=False)
        self.fc1_bn = BatchNorm(FEATURE_DIM)
        self.ball = BatchNorm(FEATURE_DIM)


def _seeded(net):
    from ..models.layers import flax_default_init_
    flax_default_init_(net, torch.Generator().manual_seed(0))
    return net


def patches(batch: int) -> np.ndarray:
    """The JAX tool's input: uniform [0, 255) (batch, 128, 64, 3)."""
    return np.random.RandomState(0).uniform(
        0, 255, (batch, 128, 64, 3)).astype(np.float32)


@torch.inference_mode()
def wide_equals_marsnet(x, dev, dtype=torch.bfloat16) -> bool:
    """Wide(32, 64, 128) with a seeded MarsNet's state dict gives that
    MarsNet's output on x, bit for bit."""
    stock = _seeded(MarsNet())
    wide = Wide(32, 64, 128)
    wide.load_state_dict(stock.state_dict())
    a = stock.to(dev, dtype).eval()(x)
    b = wide.to(dev, dtype).eval()(x)
    return bool(torch.equal(a, b))


def parser():
    p = argparse.ArgumentParser(
        description="MARS against widened variants on one card.")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None, *, variants=VARIANTS, rounds=ROUNDS) -> int:
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    info = bench.device_info(dev)
    x = torch.from_numpy(patches(args.batch)).to(dev)
    print(f"batch={args.batch} reps={args.reps} device="
          f"{info['device']['name'] or 'cpu'}", flush=True)
    equal = wide_equals_marsnet(x, dev)
    print(f"Wide(32, 64, 128) == MarsNet on the same weights: {equal}",
          flush=True)
    nets = {name: _seeded(Wide(*w)).to(dev, torch.bfloat16).eval()
            for name, w in variants}
    with torch.inference_mode():
        times, _ = bench.interleaved_ms(
            dev, {name: (lambda _, n=net: n(x), None)
                  for name, net in nets.items()}, rounds, args.reps)
    rows, base = [], float(np.median(times[variants[0][0]]))
    for name, widths in variants:
        t = float(np.median(times[name]))
        rows.append({"variant": name.split()[0], "widths": list(widths),
                     **bench.spread("ms_per_batch", times[name]),
                     "us_per_crop": t / args.batch * 1e3,
                     "vs_stock": t / base})
        print(f"{name}: {t:.2f} ms/batch = {t / args.batch * 1e3:.2f} "
              "us/crop", flush=True)
    for name, widths in variants[1:]:
        t = float(np.median(times[name]))
        # a conv's FLOPs grow with the square of its width
        print(f"{name} vs stock: {t / base:.2f}x wall-clock for "
              f"{(widths[0] / variants[0][1][0]) ** 2:.0f}x conv FLOPs",
              flush=True)
    line = {"metric": "MARS width variants: ms a batch", "variants": rows,
            "wide_equals_marsnet": equal, "batch": args.batch,
            "reps": args.reps, "rounds": rounds, "dtype": "bf16", **info}
    print(json.dumps(line), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
