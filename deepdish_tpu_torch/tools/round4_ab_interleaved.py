"""Single-process, interleaved A/Bs of the fused step on one card.

Port of the repository's tools/round4_ab_interleaved.py. Host-clock
figures of separate processes move up to 2x between calls on the card's
shared host, so every comparison here runs all its legs INTERLEAVED in one
process: round-robin A, B, C per timing round, ROUNDS rounds, the median
per leg. The ratios then hold even when the absolute numbers move.

Modes (combine freely):
  --weights ART   rand-float vs real-float vs real-int8 fused step on one
                  SSD file (a full-integer .tflite: real-float converts it
                  to float, real-int8 runs it on the integer executor,
                  models/qgraph.py), encode capacity 8;
  --mars-bisect   where an int8-MARS cost lives: MARS standalone at batch
                  256 and 1024 (bf16 against int8 with impl "conv", the
                  JAX tool's choice), crop -> MARS (`crop_resize_patches_mxu`
                  of CHUNK frames x 8 boxes, then each net), and the fused
                  step at encode capacity 8, mars against mars-int8;
  --mars-cap32    the fused step at encode capacity 32, mars against
                  mars-int8;
  --det-int8      the fused step with the float SSD, the w8a8 SSD
                  (models/ssd_q.py), the w8a8 SSD with int8 depthwise
                  (`quantize_dw`) and the w8a8 SSD with mars-int8, at
                  encode capacity 8 and 32.

The fused step is bench.py's (`FrameStep.run_chunk` over CHUNK frames at
H x W, tracker T = 64, D = 32, G = 64, four labels, labels person and car);
its frames are the JAX tool's (dark noise with one bright block), made
once and kept on the card. Weights are random and seeded (the registry's),
or the `donors` seam's (SSD, MARS) state dicts. The mars-int8 encoder runs
the CLI's impl ("auto", i.e. "dot").

Timing: a fused leg runs one untimed call, then in each round REPS calls
chained through the tracker state (which carries across rounds), with
CUDA events around them and a forced host read of the last call's track
ids ending the round (`bench.round_ms`); standalone legs the same with a
fixed input (`bench.interleaved_ms`). Each round starts with a load
marker (`probe_ms`: a chain of eight 1024^3 bf16 products, timed on the
card).

  python -m deepdish_tpu_torch.tools.round4_ab_interleaved \
      [--weights FILE.tflite] [--mars-bisect] [--mars-cap32] [--det-int8] \
      [--device cuda]

Prints the JAX tool's lines, then one JSON line last: per mode its legs'
median, min and max ms a frame (fused) or a call (standalone) over the
rounds, the load markers, the LSAP launches of its fused legs, every ratio
the JAX tool prints (`ratios`), and the bench's `platform` and `device`
keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import bench

H, W = 720, 1280
CHUNK = 32
REPS = 16
ROUNDS = 4
BATCHES = (256, 1024)      # --mars-bisect's standalone MARS batches
BOXES = 8                  # --mars-bisect's crops a frame
PROBE_N = 1024             # the load marker's matmul side


class Sizes(NamedTuple):
    """The sizes the modes run at (main's seams)."""
    chunk: int = CHUNK
    height: int = H
    width: int = W
    rounds: int = ROUNDS
    reps: int = REPS
    probe_n: int = PROBE_N

    def frames(self, dev) -> torch.Tensor:
        return torch.from_numpy(frames(self.chunk, self.height,
                                       self.width)).to(dev)

    def legs(self, legs, dev, frames_dev=None):
        """`fused_legs` at these sizes, with the load marker."""
        return fused_legs(legs, self.frames(dev) if frames_dev is None
                          else frames_dev, self.rounds, self.reps,
                          lambda: probe_ms(dev, self.probe_n))


def frames(chunk: int = CHUNK, h: int = H, w: int = W) -> np.ndarray:
    """The JAX tool's frames: (chunk, h, w, 3) uint8 noise in [0, 80) with
    a bright block at rows 200-500, columns 300-460."""
    f = np.random.RandomState(0).randint(0, 80, (chunk, h, w, 3))
    f = f.astype(np.uint8)
    f[:, 200:500, 300:460] = 230
    return f


def probe_ms(dev, n: int = PROBE_N) -> float:
    """A per-round load marker: ms of one chain of eight n^3 bf16
    products, timed on the card."""
    x = torch.ones((n, n), dtype=torch.bfloat16, device=dev)

    def chain(_):
        z = x
        for _ in range(8):
            z = z @ x
        return z
    return bench.round_ms(dev, chain, 1)


def detector(name, dev, donors=None):
    """The fused step's SSD: "ssd_mobilenet" (float), "ssd_mobilenet_int8"
    (w8a8), "int8-dw" (w8a8 with int8 depthwise, its labels set after
    construction as the registry does) or a weight file; max_outputs 32;
    the donors' SSD weights for the named ones."""
    from ..models import create_detector
    sd = donors[0] if donors is not None else None
    if name != "int8-dw":
        return create_detector(name, max_outputs=32, device=dev,
                               state_dict=None if os.path.isfile(name)
                               else sd)
    from ..models.registry import load_labels
    from ..models.ssd_q import SSDMobileNetInt8Detector
    det = SSDMobileNetInt8Detector(state_dict=sd, max_outputs=32,
                                   quantize_dw=True, device=dev)
    # FrameStep reads max(detector.labels) + 1 at construction
    det.labels = dict(enumerate(load_labels(None)))
    det.label_offset = 0
    return det


def encoder(name: str, dev, donors=None):
    """The named encoder ("mars" or "mars-int8"), on the donors' MARS
    weights if given."""
    from ..models import create_box_encoder
    return create_box_encoder(name, device=dev, state_dict=(
        donors[1] if donors is not None else None))


def framestep(det, enc, cap: int, dev, h=H, w=W):
    """bench.py's FrameStep on `det` and `enc` at encode capacity `cap`."""
    from .. import tracker as tt
    from ..pipeline import FrameStep, FrameStepConfig
    return FrameStep(det, enc, tt.TrackerConfig(**bench.TRACKER),
                     list(bench.WANTED), (h, w),
                     FrameStepConfig(encode_capacity=cap), device=dev)


@torch.inference_mode()
def fused_legs(legs, frames_dev, rounds=ROUNDS, reps=REPS, load=None):
    """legs [(name, FrameStep)] on frames_dev's device: one untimed call
    each (`first_call_s`, the JAX tool's compile pass), then `rounds`
    rounds of `reps` state-chained `run_chunk` calls per leg, legs in
    turns, each round after the load marker `load()` if given. Returns
    {"legs": {name: ms a frame median / min / max / rounds and FPS at the
    median}, "first_call_s", "probe_ms", "lsap_launches"} and prints the
    JAX tool's rows."""
    from ..kernels import lsap
    dev = frames_dev.device
    chunk = frames_dev.shape[0]
    launches0 = lsap.launches
    states, first = {}, {}
    for name, fs in legs:
        t0 = time.perf_counter()
        s, o, _ = fs.run_chunk(fs.init_state(), frames_dev)
        bench.read(dev, o.track_id)
        states[name] = s
        first[name] = time.perf_counter() - t0
        print(f"  first call {name}: {first[name]:.1f}s", flush=True)
    times = {n: [] for n, _ in legs}
    loads = []
    for rnd in range(rounds):
        if load is not None:
            loads.append(load())
        for name, fs in legs:
            def chain(n, name=name, fs=fs):
                s = states[name]
                for _ in range(n):
                    s, o, _ = fs.run_chunk(s, frames_dev)
                states[name] = s
                return o.track_id
            times[name].append(bench.round_ms(dev, chain, reps) / chunk)
        row = "  ".join(f"{n}={times[n][-1]:7.3f}ms/f" for n, _ in legs)
        marker = f"probe={loads[-1]:6.1f}ms  " if loads else ""
        print(f"  round {rnd}: {marker}{row}", flush=True)
    print("  MEDIANS:", flush=True)
    out = {}
    for name, _ in legs:
        t = float(np.median(times[name]))
        out[name] = {**bench.spread("ms_per_frame", times[name]),
                     "fps": 1e3 / t}
        print(f"    {name:12s}: {t:7.3f} ms/frame ({1e3 / t:7.0f} FPS)",
              flush=True)
    return {"legs": out, "first_call_s": first, "probe_ms": loads,
            "lsap_launches": lsap.launches - launches0}


def _med(group, name):
    return group["legs"][name]["ms_per_frame"]


def ab_weights(artifact, dev, sz, donors=None):
    print(f"== fused step A/B, chunk {sz.chunk}, enc_cap 8, RGB transport "
          "==", flush=True)
    from ..models import create_detector
    enc = encoder("mars", dev, donors)
    dets = [("rand-float", detector("ssd_mobilenet", dev, donors)),
            ("real-float", detector(artifact, dev)),
            ("real-int8", create_detector(artifact, max_outputs=32,
                                          quantized=True, device=dev))]
    legs = [(n, framestep(d, enc, 8, dev, sz.height, sz.width))
            for n, d in dets]
    g = sz.legs(legs, dev)
    g["ratios"] = {"real/rand-float": _med(g, "real-float")
                   / _med(g, "rand-float"),
                   "int8/float": _med(g, "real-int8") / _med(g, "real-float")}
    print("  RATIOS: " + "  ".join(f"{k}={v:.2f}"
                                   for k, v in g["ratios"].items()),
          flush=True)
    return g


def mars_cap32(dev, sz, donors=None):
    print("== fused step cap32: mars vs mars-int8 (interleaved) ==",
          flush=True)
    det = detector("ssd_mobilenet", dev, donors)
    legs = [(n, framestep(det, encoder(n, dev, donors), 32, dev, sz.height,
                          sz.width)) for n in ("mars", "mars-int8")]
    g = sz.legs(legs, dev)
    g["ratios"] = {"cap32 int8/bf16": _med(g, "mars-int8") / _med(g, "mars")}
    print(f"  RATIO cap32 int8/bf16: {g['ratios']['cap32 int8/bf16']:.2f}",
          flush=True)
    return g


DET_LEGS = (("float", "ssd_mobilenet", "mars"),
            ("det-i8", "ssd_mobilenet_int8", "mars"),
            ("det-i8dw", "int8-dw", "mars"),
            ("all-i8", "ssd_mobilenet_int8", "mars-int8"))


def det_int8(dev, sz, donors=None):
    print("== fused step: detector float vs fast-int8 (interleaved) ==",
          flush=True)
    # the detectors and encoders serve both capacities
    dets = {d: detector(d, dev, donors) for _, d, _ in DET_LEGS}
    encs = {e: encoder(e, dev, donors) for _, _, e in DET_LEGS}
    out = {}
    for cap in (8, 32):
        legs = [(f"{name}/c{cap}",
                 framestep(dets[d], encs[e], cap, dev, sz.height, sz.width))
                for name, d, e in DET_LEGS]
        g = sz.legs(legs, dev)
        f = _med(g, f"float/c{cap}")
        g["ratios"] = {f"{n}/c{cap}/float": _med(g, f"{n}/c{cap}") / f
                       for n, _, _ in DET_LEGS[1:]}
        for k, v in g["ratios"].items():
            print(f"  RATIO {k}: {v:.3f}", flush=True)
        out[f"c{cap}"] = g
    return out


def mars_nets(dev, donors=None):
    """The standalone legs' MARS: a bf16 MarsNet on `dev` (the donors'
    weights, else flax's draw from a generator seeded with 0) and its int8
    qparams there, calibrated in bf16 as in the JAX tools."""
    from ..models import mars_q
    from ..models.layers import flax_default_init_
    from ..models.mars import MarsNet
    net = MarsNet()
    if donors is not None:
        net.load_state_dict(donors[1])
    else:
        flax_default_init_(net, torch.Generator().manual_seed(0))
    params = {k: v.detach().float().to(dev)
              for k, v in net.state_dict().items()}
    qp = mars_q.prepare_qparams(mars_q.quantize_mars(
        params, compute_dtype=torch.bfloat16), dev)
    return net.to(dev, torch.bfloat16).eval(), qp


@torch.inference_mode()
def mars_bisect(dev, sz, batches=BATCHES, donors=None):
    from ..models import mars_q
    from ..models.mars import INPUT_SHAPE
    from ..models.preprocess import crop_resize_patches_mxu
    bf16 = torch.bfloat16
    net, qp = mars_nets(dev, donors)

    def int8(v):
        return mars_q.mars_int8_apply(qp, v, bf16, impl="conv")

    out = {"standalone": {}, "ratios": {}}
    print("== standalone MARS: batch x impl (interleaved per batch) ==",
          flush=True)
    for batch in batches:
        x = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (batch,) + INPUT_SHAPE).astype(np.float32)).to(dev)
        times, _ = bench.interleaved_ms(
            dev, {"bf16": (lambda _: net(x), x),
                  "int8/conv": (lambda _: int8(x), x)}, sz.rounds, sz.reps)
        tb, tq = (float(np.median(times[k])) for k in ("bf16", "int8/conv"))
        out["standalone"][str(batch)] = {
            k: bench.spread("ms", v) for k, v in times.items()}
        out["ratios"][f"batch {batch} bf16/int8-conv"] = tb / tq
        print(f"  batch {batch:5d}: bf16 {tb:8.3f} ms  int8/conv {tq:8.3f} "
              f"ms  ratio x{tb / tq:.2f}", flush=True)

    print(f"== crop->MARS composition (fused producer), {sz.chunk}f x "
          f"{BOXES} boxes ==", flush=True)
    frames_dev = sz.frames(dev)
    tlwh = torch.tensor([300.0, 200.0, 160.0, 300.0], device=dev).expand(
        sz.chunk, BOXES, 4).contiguous()
    ok = torch.ones((sz.chunk, BOXES), dtype=torch.bool, device=dev)

    def crop_then(apply_fn):
        def f(_):
            patches, _ = crop_resize_patches_mxu(frames_dev, tlwh, ok,
                                                 INPUT_SHAPE[0],
                                                 INPUT_SHAPE[1])
            return apply_fn(patches.reshape((-1,) + patches.shape[2:]))
        return f
    times, _ = bench.interleaved_ms(
        dev, {"crop+bf16": (crop_then(net), None),
              "crop+int8": (crop_then(int8), None)}, sz.rounds, sz.reps)
    tb, tq = (float(np.median(times[k])) for k in ("crop+bf16", "crop+int8"))
    out["crop"] = {k: bench.spread("ms", v) for k, v in times.items()}
    out["ratios"]["crop bf16/int8"] = tb / tq
    print(f"  crop+bf16 {tb:8.3f} ms  crop+int8 {tq:8.3f} ms  ratio "
          f"x{tb / tq:.2f}", flush=True)

    print("== fused step cap8: mars vs mars-int8 (interleaved) ==",
          flush=True)
    det = detector("ssd_mobilenet", dev, donors)
    legs = [(n, framestep(det, encoder(n, dev, donors), 8, dev, sz.height,
                          sz.width)) for n in ("mars", "mars-int8")]
    out["fused_cap8"] = sz.legs(legs, dev, frames_dev)
    return out


def parser():
    p = argparse.ArgumentParser(
        description="Interleaved A/Bs of the fused step on one card.")
    p.add_argument("--weights", help="an SSD .tflite (full-integer for the "
                   "real-int8 leg)")
    p.add_argument("--mars-bisect", action="store_true")
    p.add_argument("--mars-cap32", action="store_true")
    p.add_argument("--det-int8", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None, *, chunk=CHUNK, height=H, width=W, rounds=ROUNDS,
         reps=REPS, batches=BATCHES, probe_n=PROBE_N, donors=None) -> int:
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    info = bench.device_info(dev)
    print("device:", info["device"]["name"] or "cpu", flush=True)
    sz = Sizes(chunk, height, width, rounds, reps, probe_n)
    pool = probe_ms(dev, probe_n)
    print(f"pool probe: {pool:.1f} ms (8-chain {probe_n}^3 bf16)",
          flush=True)
    line = {"metric": "interleaved fused-step A/Bs: ms a frame",
            "modes": [], "pool_probe_ms": pool}
    groups = []
    if args.weights:
        line["weights"] = ab_weights(args.weights, dev, sz, donors)
        groups.append(line["weights"])
    if args.mars_bisect:
        line["mars_bisect"] = mars_bisect(dev, sz, batches, donors)
        groups += [line["mars_bisect"], line["mars_bisect"]["fused_cap8"]]
    if args.mars_cap32:
        line["mars_cap32"] = mars_cap32(dev, sz, donors)
        groups.append(line["mars_cap32"])
    if args.det_int8:
        line["det_int8"] = det_int8(dev, sz, donors)
        groups += list(line["det_int8"].values())
    line["modes"] = [m for m in ("weights", "mars_bisect", "mars_cap32",
                                 "det_int8") if m in line]
    line.update(ratios={k: v for g in groups
                        for k, v in g.get("ratios", {}).items()},
                lsap_launches=sum(g.get("lsap_launches", 0) for g in groups),
                **sz._asdict(), **info)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
