"""bf16 MARS against the w8a8 (int8) MARS on one card, standalone and in
the fused step.

Port of the repository's tools/profile_mars_int8.py. MARS's 32- and
64-wide convolutions leave the tensor cores mostly idle (MARS at batch
1024 reaches a few percent of the bf16 peak); the int8 encoder
(models/mars_q.py) runs the same contractions as exact int8 products.
This measures whether it buys time:

  standalone  MarsNet in bf16 against `mars_int8_apply` with impl "dot"
              (im2col + `torch._int_mm`, the CLI's path) and impl "conv"
              (a direct float64 convolution of the int8 codes, cuDNN off)
              at batch BATCH (1024) of seeded 128x64 patches, the legs in
              turns; the two impls' features must be bit-equal
              (`dot_conv_features_equal`);
  fused       `FrameStep.run_chunk` at chunk CHUNK (32), 720p, encode
              capacity 32 and 8, encoders "mars" and "mars-int8", bench.py's
              tracker and labels (round4_ab_interleaved.framestep), the
              state carried across calls.

Weights are random and seeded (the registry's), or the `donors` seam's
(SSD, MARS) state dicts; MARS runs in bf16, its int8 version calibrated
in bf16, as in the JAX tool. Timing: ROUNDS rounds of REPS calls
(standalone) or FUSED_REPS state-chained calls (fused), CUDA events around
each round and a forced host read ending it (`bench.round_ms`).

  python -m deepdish_tpu_torch.tools.profile_mars_int8 [--device cuda]

Prints the JAX tool's lines, then one JSON line last: each leg's median,
min and max ms (a batch, or a frame) over its rounds, crops/s and
frames/s at the median, the ratios int8 / bf16, the fused legs' LSAP
launches, and the bench's `platform` and `device` keys. Exits 1 when the
two impls' features differ.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import bench
from . import round4_ab_interleaved as ab

BATCH = 1024
CHUNK = 32
CAPS = (32, 8)
REPS = 32                  # standalone calls a round
FUSED_REPS = 16            # fused calls a round
ROUNDS = 3
IMPLS = ("dot", "conv")


@torch.inference_mode()
def standalone(dev, batch=BATCH, rounds=ROUNDS, reps=REPS, donors=None):
    """bf16 MARS and the int8 MARS with each impl on one batch, in turns.
    Returns the legs' JSON and whether the two impls' features are
    bit-equal."""
    from ..models import mars_q
    from ..models.mars import INPUT_SHAPE
    print(f"-- standalone MARS, batch {batch} --", flush=True)
    bf16 = torch.bfloat16
    net, qp = ab.mars_nets(dev, donors)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (batch,) + INPUT_SHAPE).astype(np.float32)).to(dev)
    legs = {"bf16": (lambda _: net(x), x)}
    for impl in IMPLS:
        legs[f"int8/{impl}"] = (lambda _, i=impl: mars_q.mars_int8_apply(
            qp, x, bf16, impl=i), x)
    times, last = bench.interleaved_ms(dev, legs, rounds, reps)
    rows = {}
    for name, ms in times.items():
        t = float(np.median(ms))
        rows[name] = {**bench.spread("ms_per_batch", ms),
                      "crops_per_s": batch * 1e3 / t}
        print(f"{name:9s}: {t:8.3f} ms/batch  ({batch * 1e3 / t:8.0f} "
              "crops/s)", flush=True)
    equal = bool(torch.equal(last["int8/dot"], last["int8/conv"]))
    print(f"int8/dot and int8/conv features bit-equal: {equal}", flush=True)
    return rows, equal


def fused(dev, enc_cap, chunk=CHUNK, h=ab.H, w=ab.W, rounds=ROUNDS,
          reps=FUSED_REPS, donors=None):
    """Each encoder's fused step timed on its own, as the JAX tool does."""
    print(f"-- fused step, chunk {chunk}, enc_cap {enc_cap} --", flush=True)
    det = ab.detector("ssd_mobilenet", dev, donors)
    frames = torch.from_numpy(ab.frames(chunk, h, w)).to(dev)
    out = {"legs": {}, "first_call_s": {}, "lsap_launches": 0}
    for name in ("mars", "mars-int8"):
        fs = ab.framestep(det, ab.encoder(name, dev, donors), enc_cap, dev,
                          h, w)
        g = ab.fused_legs([(name, fs)], frames, rounds, reps)
        out["legs"][name] = g["legs"][name]
        out["first_call_s"][name] = g["first_call_s"][name]
        out["lsap_launches"] += g["lsap_launches"]
    return out


def parser():
    p = argparse.ArgumentParser(
        description="bf16 MARS against the int8 MARS on one card.")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None, *, batch=BATCH, chunk=CHUNK, height=ab.H, width=ab.W,
         rounds=ROUNDS, reps=REPS, fused_reps=FUSED_REPS,
         donors=None) -> int:
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    info = bench.device_info(dev)
    print("device:", info["device"]["name"] or "cpu", flush=True)
    rows, equal = standalone(dev, batch, rounds, reps, donors)
    b = rows["bf16"]["ms_per_batch"]
    ratios = {f"int8/{i} / bf16": rows[f"int8/{i}"]["ms_per_batch"] / b
              for i in IMPLS}
    line = {"metric": "bf16 MARS against int8 MARS: ms a batch / a frame",
            "standalone": rows, "dot_conv_features_equal": equal,
            "fused": {}}
    for cap in CAPS:
        g = fused(dev, cap, chunk, height, width, rounds, fused_reps, donors)
        line["fused"][f"cap{cap}"] = g
        ratios[f"fused cap{cap} int8/bf16"] = (
            g["legs"]["mars-int8"]["ms_per_frame"]
            / g["legs"]["mars"]["ms_per_frame"])
    line.update(ratios=ratios,
                lsap_launches=sum(g["lsap_launches"]
                                  for g in line["fused"].values()),
                batch=batch, chunk=chunk, height=height, width=width,
                rounds=rounds, reps=reps, fused_reps=fused_reps, **info)
    print(json.dumps(line), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
