"""Micro-benchmarks of the pieces inside the frame step, on one card:
detector conv types, MARS variants, the tracker's internals, the LSAP
solvers, argsort.

Port of the repository's tools/profile_micro.py: its groups and legs at its
shapes, each leg timed over --reps calls after one warm-up call. A leg
reports three figures a call (medians): host ms (the host clock from the
call to its return: launches, and any host syncs inside), device ms (CUDA
events recorded around the same call, read after a synchronize; none on
the CPU) and host syncs (`device.host_syncs`, what ROADMAP item 3
removes).

  ssd   the JAX tool's 13-layer depthwise and regular-conv backbones
        (`Backbone`) at batch --batch (32), --size (300) square, from
        uint8; the SSD-MobileNetV1 network forward and the full `detect`
        (network, decode, per-class NMS) at 1280x720, both at batch
        --batch and the network's own 300x300;
  mars  MarsNet in bf16 and float32 (ELU, batch norms) at batch
        --mars-batch (1024), 128x64; the same shape with ReLU and no
        batch norms (`MarsRelu`);
  trk   at T = 64, D = 32 (the JAX tool's tracker: G = 64, four labels):
        the LSAP on a 64x64 matrix, plain PyTorch and, on the card, the
        CUDA kernel (both must give the same assignment); argsort of 64;
        Kalman predict / gating / update; `tracker.step` on an empty table
        and on 32 live tracks; 32 `tracker.step` calls one after another
        (the port's counterpart of the JAX tool's `lax.scan`).

Inputs are the JAX tool's draws from np.random.RandomState(0); module
weights come from a seeded torch.Generator (only the timing matters for
them). Networks run in the device's default compute dtype (bf16 on the
card, float32 on the CPU) unless a leg names its own.

  python -m deepdish_tpu_torch.tools.profile_micro [--reps 32] \
      [--only ssd,mars,trk] [--device cuda]

Prints a table per group, then one JSON line last with every leg and the
bench's `platform` and `device` keys.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import bench

GROUPS = ("ssd", "mars", "trk")
# the JAX tool's backbone: (features, stride) after the stride-2 stem
BACKBONE = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
T_TRACKS, D_DETS = 64, 32


def _conv(cin, cout, k, stride=1, groups=1, bias=False):
    from ..models.layers import SameConv2d
    return SameConv2d(cin, cout, k, stride=stride, groups=groups, bias=bias)


class Backbone(nn.Module):
    """tools/profile_micro.py `DWStack`: uint8 NHWC -> x / 127.5 - 1 ->
    3x3/2 conv to 32 -> 13 x (3x3 conv, depthwise or regular, relu6, 1x1
    conv, relu6), every conv without bias."""

    def __init__(self, regular: bool = False):
        super().__init__()
        layers = [_conv(3, 32, 3, 2)]
        cin = 32
        for c, s in BACKBONE:
            layers += [_conv(cin, cin, 3, s, 1 if regular else cin),
                       _conv(cin, c, 1)]
            cin = c
        self.convs = nn.ModuleList(layers)

    def forward(self, x):
        w = self.convs[0].weight
        x = (x.to(w.dtype) / 127.5 - 1.0).permute(0, 3, 1, 2)
        x = self.convs[0](x)
        for conv in self.convs[1:]:
            x = F.relu6(conv(x))
        return x


class MarsRelu(nn.Module):
    """tools/profile_micro.py `MarsRelu`: MARS's shape with ReLU and no
    batch norms, 128x64x3 -> 128."""

    def __init__(self):
        super().__init__()
        self.c1, self.c2 = _conv(3, 32, 3), _conv(32, 32, 3)
        self.blocks = nn.ModuleList()
        x = 32
        for feats, inc in [(32, False), (32, False), (32, True),
                           (64, False), (64, True), (128, False)]:
            n = feats * (2 if inc else 1)
            self.blocks.append(nn.ModuleList(
                [_conv(x, n, 3, 2 if inc else 1), _conv(n, n, 3, bias=True)]
                + ([_conv(x, n, 1, 2)] if inc else [])))
            x = n
        self.fc = nn.Linear(16 * 8 * 128, 128, bias=False)

    def forward(self, x):
        x = x.to(self.c1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.c2(F.relu(self.c1(x))))
        x = F.max_pool2d(x, 3, 2)
        for b in self.blocks:
            y = b[1](F.relu(b[0](x)))
            x = (b[2](x) if len(b) == 3 else x) + y
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def _init(module, dev, dtype):
    from ..models.layers import flax_default_init_
    flax_default_init_(module, torch.Generator().manual_seed(0))
    return module.to(dev, dtype).eval().requires_grad_(False)


class Timer:
    """Runs legs on `dev`, `reps` timed calls each, and keeps their rows."""

    def __init__(self, dev, reps):
        self.dev, self.reps, self.rows = dev, reps, []

    @torch.inference_mode()
    def leg(self, group, label, fn, setup=None):
        """fn(setup()) once, then `reps` timed calls (setup outside the
        timing); returns the last output."""
        from .. import device as devmod
        cuda = self.dev.type == "cuda"
        out = fn(setup() if setup else None)
        bench.sync(self.dev)
        host, device, syncs = [], [], 0
        for _ in range(self.reps):
            arg = setup() if setup else None
            bench.sync(self.dev)
            before = devmod.host_syncs
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            out = fn(arg)
            host.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                end.record()
            syncs += devmod.host_syncs - before
            bench.sync(self.dev)
            if cuda:
                device.append(start.elapsed_time(end))
        row = {"group": group, "leg": label,
               "host_ms": float(np.median(host)),
               "device_ms": float(np.median(device)) if cuda else None,
               "host_syncs": syncs / self.reps}
        self.rows.append(row)
        dev_ms = (f"{row['device_ms']:9.3f}" if cuda else "        -")
        print(f"  {label:40s} {row['host_ms']:9.3f} {dev_ms} "
              f"{row['host_syncs']:6.2f}", flush=True)
        return out


def ssd_legs(tm, batch=32, size=300):
    from ..models.preprocess import default_compute_dtype
    from ..models.registry import create_detector
    dev = tm.dev
    dtype = default_compute_dtype(dev)

    def draw(side):
        return torch.from_numpy(np.random.RandomState(0).randint(
            0, 255, (batch, side, side, 3)).astype(np.uint8)).to(dev)
    x = draw(size)
    for label, regular in (("depthwise backbone", False),
                           ("regular-conv backbone", True)):
        net = _init(Backbone(regular), dev, dtype)
        tm.leg("ssd", label, lambda _, n=net: n(x))
    det = create_detector("ssd_mobilenet", max_outputs=32, device=dev)
    # the network at its own input size (300), whatever --size is
    imgs = (x if size == det.height else draw(det.height)).float()
    tm.leg("ssd", "ssd net fwd", lambda _: det._apply_net(imgs))
    tm.leg("ssd", "ssd full detect",
           lambda _: det.detect(imgs, 1280.0, 720.0))


def mars_legs(tm, batch=1024):
    from ..models.mars import MarsNet
    dev = tm.dev
    patches = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (batch, 128, 64, 3)).astype(np.float32)).to(dev)
    dtypes = [("bf16", torch.bfloat16), ("f32", torch.float32)]
    for label, dtype in dtypes:
        net = _init(MarsNet(), dev, dtype)
        tm.leg("mars", f"mars {label} elu", lambda _, n=net: n(patches))
    net = _init(MarsRelu(), dev, torch.bfloat16)
    tm.leg("mars", "mars-shape bf16 relu (no BN/elu)",
           lambda _: net(patches))


def trk_inputs(dev):
    """The JAX tool's draws, in its order, from np.random.RandomState(0):
    a 64x64 LSAP cost, an argsort vector, Kalman means (64, 8), identity
    covariances, 32 and 64 measurements, and 32 detections with 128-wide
    features; as numpy (`np`) and as tensors on `dev`."""
    rng = np.random.RandomState(0)
    d = {"cost": rng.rand(64, 64).astype(np.float32),
         "v": rng.rand(64).astype(np.float32),
         "mean": rng.rand(64, 8).astype(np.float32),
         "cov": np.tile(np.eye(8, dtype=np.float32), (64, 1, 1)),
         "meas": rng.rand(32, 4).astype(np.float32),
         "z64": rng.rand(64, 4).astype(np.float32),
         "tlwh": rng.rand(32, 4).astype(np.float32) * 200,
         "feature": rng.rand(32, 128).astype(np.float32)}
    return d, {k: torch.from_numpy(v).to(dev) for k, v in d.items()}


def tracker_config():
    from .. import tracker as tt
    return tt.TrackerConfig(max_tracks=T_TRACKS, max_detections=D_DETS,
                            gallery_size=64, num_labels=4)


def _clone(table):
    return type(table)(*(t.clone() for t in table))


def trk_legs(tm):
    """The trk group; returns the outputs the legs computed (`lsap`,
    `lsap_kernel` on the card, `argsort`, `predict`, `gating`, `update`,
    `table_live` (32 live tracks), `table_after` (one more step on it)),
    each from its first call."""
    from .. import tracker as tt
    from ..ops import kalman
    from ..ops.assignment import solve_lsap_plain
    dev = tm.dev
    _, x = trk_inputs(dev)
    cfg = tracker_config()
    out = {}
    costs = x["cost"][None]
    sizes = torch.tensor([[64, 64]], dtype=torch.int32, device=dev)
    out["lsap"] = tm.leg("trk", "lsap plain 64x64",
                         lambda _: solve_lsap_plain(costs, sizes))[0]
    if dev.type == "cuda":
        from ..kernels import lsap
        out["lsap_kernel"] = tm.leg("trk", "lsap cuda kernel 64x64",
                                    lambda _: lsap.solve(costs, sizes))[0]
        if not torch.equal(out["lsap"], out["lsap_kernel"]):
            raise RuntimeError("the LSAP kernel's assignment differs from "
                               "the plain version's on the 64x64 input")
    out["argsort"] = tm.leg("trk", "argsort(64)",
                            lambda _: torch.argsort(x["v"]))
    out["predict"] = tm.leg("trk", "kalman predict_v",
                            lambda _: kalman.predict_v(x["mean"], x["cov"]))
    out["gating"] = tm.leg("trk", "kalman gating_v",
                           lambda _: kalman.gating_distance_v(
                               x["mean"], x["cov"], x["meas"]))
    out["update"] = tm.leg("trk", "kalman update_v",
                           lambda _: kalman.update_v(x["mean"], x["cov"],
                                                     x["z64"]))
    dets = tt.Detections(
        tlwh=x["tlwh"], confidence=torch.ones(32, device=dev),
        label=torch.zeros(32, dtype=torch.int32, device=dev),
        feature=x["feature"], valid=torch.ones(32, dtype=torch.bool,
                                               device=dev))
    empty = tt.create_table(cfg, dev)
    # tracker.step writes the gallery ring of its table in place: each
    # call steps a fresh copy
    tm.leg("trk", "tracker.step (empty table)",
           lambda t: tt.step(cfg, t, dets), setup=lambda: _clone(empty))
    with torch.inference_mode():
        live, _ = tt.step(cfg, _clone(empty), dets)
        live, _ = tt.step(cfg, live, dets)
    out["table_live"] = _clone(live)
    out["table_after"] = tm.leg(
        "trk", "tracker.step (32 live tracks)",
        lambda t: tt.step(cfg, t, dets), setup=lambda: _clone(live))[0]

    def steps32(t):
        for _ in range(32):
            t, _ = tt.step(cfg, t, dets)
        return t
    tm.leg("trk", "32 tracker.steps one after another", steps32,
           setup=lambda: _clone(live))
    return out


def parser():
    p = argparse.ArgumentParser(
        description="Micro-benchmarks of the port's frame-step pieces.")
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--only", default=",".join(GROUPS))
    p.add_argument("--batch", type=int, default=32,
                   help="ssd: frames a call")
    p.add_argument("--size", type=int, default=300, help="ssd: input side")
    p.add_argument("--mars-batch", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    info = bench.device_info(dev)
    only = [g for g in args.only.split(",") if g]
    bad = [g for g in only if g not in GROUPS]
    if bad:
        raise ValueError(f"--only takes {GROUPS}, got {bad}")
    tm = Timer(dev, args.reps)
    head = f"  {'leg':40s} {'host ms':>9s} {'device ms':>9s} {'syncs':>6s}"
    if "ssd" in only:
        print(f"SSD detector pieces (batch {args.batch}, {args.size}x"
              f"{args.size}):\n{head}")
        ssd_legs(tm, args.batch, args.size)
    if "mars" in only:
        print(f"MARS variants (batch {args.mars_batch}, 128x64):\n{head}")
        mars_legs(tm, args.mars_batch)
    lsap_equal = None
    if "trk" in only:
        print(f"tracker internals (T={T_TRACKS}, D={D_DETS}):\n{head}")
        out = trk_legs(tm)
        lsap_equal = (bool(torch.equal(out["lsap"], out["lsap_kernel"]))
                      if "lsap_kernel" in out else None)
    line = {"metric": "micro-benchmarks of the frame step's pieces",
            "legs": tm.rows, "reps": args.reps, "groups": only,
            "ssd_batch": args.batch, "ssd_size": args.size,
            "mars_batch": args.mars_batch, "lsap_kernel_equal": lsap_equal,
            **info}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
