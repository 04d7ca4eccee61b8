"""Per-frame time of each stage of one chunk, on one card.

Port of the repository's tools/profile_components.py. At --chunk frames
(default 32) of bench.py's synthetic 720p scene it times the JAX tool's
eight figures, each the median over --reps calls of the port's own piece:

  resize           FrameStep.detector_input (models/preprocess.py
                   resize_bilinear_mxu; letterboxed for YOLOv3)
  detector raw     FrameStep._detect_raw (resize included)
  det+filter+NMS   _detect_raw, then FrameStep._filter_and_nms
  crop             crop_resize_patches_mxu of the post-NMS boxes (the
                   first --enc-cap of them; 0 = all D)
  MARS             the encoder's forward over the F x E crops as one batch
  crop+MARS        the crop and the forward as run_chunk does them
  tracker scan     tracker.step over the chunk's frames, one after another
                   (from a copy of a fresh table each call)
  run_chunk        FrameStep.run_chunk from a fresh state

On the card each call is timed by CUDA events recorded around it, with a
synchronize before the read (after one warm-up call); on the CPU by the
host clock. Then one torch.profiler window over run_chunk gives each
profiler range's host and device ms a frame (`framestep.*` and the
detector's `<family>.*`), the device's idle share and the ten device
kernels that take the most time. A range that runs inside another (the
tracker's `framestep.trk_*` stages, the `framestep.sync_*` host syncs) is
shown in brackets after it, as a part of it.

  python -m deepdish_tpu_torch.tools.profile_components [--chunk 32] \
      [--reps 32] [--model ssd_mobilenet|yolov5|yolov3|efficientdet|
      faster_rcnn|FILE] [--encoder mars] [--quantized] [--device cuda]

Prints the figures, the split, and last one JSON line with the bench's
`platform` and `device` keys.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import bench

FIGURES = ("resize", "detector_raw", "det_filter_nms", "crop", "mars",
           "crop_mars", "tracker_scan", "run_chunk")
LABELS = {"resize": "resize-only", "detector_raw": "detector raw (incl "
          "resize)", "det_filter_nms": "det+filter+NMS",
          "crop": "crop-only", "mars": "MARS fwd (F*E batch)",
          "crop_mars": "crop+MARS", "tracker_scan": "tracker scan",
          "run_chunk": "FULL run_chunk"}


def timed_calls(fn, reps, dev, setup=None):
    """fn(setup()) once to warm up, then `reps` timed calls (setup outside
    the timing): CUDA events around each call on the card, read after a
    synchronize; the host clock on the CPU. Returns (ms of each call, the
    last output)."""
    out = fn(setup() if setup else None)
    bench.sync(dev)
    ms = []
    for _ in range(reps):
        arg = setup() if setup else None
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(arg)
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn(arg)
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def crop_mars(fs, frames, snaps):
    """FrameStep._detect_encode_frames's crop + encoder forward: (F, E, 128)
    features, zero where a crop is not valid."""
    from ..models.preprocess import crop_resize_patches_mxu
    F, E, enc = frames.shape[0], fs._enc_cap, fs.encoder
    patches, ok = crop_resize_patches_mxu(
        frames, snaps.tlwh[:, :E], snaps.valid[:, :E], enc.height,
        enc.width, enc.compute_dtype)
    feats = enc.apply(patches.reshape((F * E,) + patches.shape[2:]))
    return torch.where(ok.reshape(F * E)[:, None], feats,
                       torch.zeros_like(feats)).reshape(F, E, -1)


def tracker_scan(fs, table, dets):
    """tracker.step over the frames of `dets` (stacked on F)."""
    from .. import tracker as tt
    outs = []
    for f in range(dets.valid.shape[0]):
        table, out = tt.step(fs.tracker_cfg, table,
                             tt.Detections(*(x[f] for x in dets)))
        outs.append(out)
    return table, outs


@torch.inference_mode()
def components(fs, frames, reps):
    """The eight figures over (F, H, W, 3) frames on fs's device: {name: ms
    of each call}, and the stages' outputs (`snaps`, `feats`)."""
    from .. import tracker as tt
    from ..models.preprocess import crop_resize_patches_mxu
    dev, F, E = fs.device, frames.shape[0], fs._enc_cap
    enc = fs.encoder
    ms = {}
    ms["resize"], _ = timed_calls(lambda _: fs.detector_input(frames), reps,
                                  dev)
    ms["detector_raw"], _ = timed_calls(lambda _: fs._detect_raw(frames),
                                        reps, dev)
    ms["det_filter_nms"], snaps = timed_calls(
        lambda _: fs._filter_and_nms(None, *fs._detect_raw(frames)), reps,
        dev)
    ms["crop"], (patches, _) = timed_calls(
        lambda _: crop_resize_patches_mxu(
            frames, snaps.tlwh[:, :E], snaps.valid[:, :E], enc.height,
            enc.width, enc.compute_dtype), reps, dev)
    flat = patches.reshape((F * E,) + patches.shape[2:])
    ms["mars"], _ = timed_calls(lambda _: enc.apply(flat), reps, dev)
    ms["crop_mars"], feats = timed_calls(
        lambda _: crop_mars(fs, frames, snaps), reps, dev)
    dets = tt.Detections(tlwh=snaps.tlwh, confidence=snaps.score,
                         label=snaps.label, feature=fs._pad_features(feats),
                         valid=snaps.valid)
    fresh = fs.init_state().table
    # tracker.step writes the gallery ring in place: each call gets a copy
    ms["tracker_scan"], _ = timed_calls(
        lambda table: tracker_scan(fs, table, dets), reps, dev,
        setup=lambda: type(fresh)(*(t.clone() for t in fresh)))
    ms["run_chunk"], _ = timed_calls(
        lambda _: fs.run_chunk(fs.init_state(), frames), reps, dev)
    return ms, {"snaps": snaps, "feats": feats}


def _enclosing_range(e):
    """The innermost profiler range around event e, or None."""
    p = e.cpu_parent
    while p is not None and not p.is_user_annotation:
        p = p.cpu_parent
    return p


def profiled(fn, n, dev, stages=None, top=10):
    """torch.profiler over fn(), which does n frames' work: per frame, each
    profiler range's host time and device time (`stages`, or every range
    the run recorded), the part of them run inside another of the ranges
    (`inside`: name -> {enclosing range: [host ms, device ms]}, e.g. the
    tracker's `framestep.trk_*` and the `framestep.sync_*` ranges), the
    device's busy and wall time (CUDA kernel and copy time over the wall;
    the profiler's own cost is in the wall), the idle share (None when no
    device time was recorded) and the `top` device kernels by time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        bench.sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type.name == "CPU"]
    if stages is None:
        stages = tuple(dict.fromkeys(e.name for e in events
                                     if e.is_user_annotation))
    host = dict.fromkeys(stages, 0.0)
    device = dict.fromkeys(stages, 0.0)
    inside = {}
    for e in events:
        if e.name in host:
            ms = (e.cpu_time_total / n / 1e3, e.device_time_total / n / 1e3)
            host[e.name] += ms[0]
            device[e.name] += ms[1]
            outer = _enclosing_range(e)
            if outer is not None and outer.name in host:
                acc = inside.setdefault(e.name, {}).setdefault(
                    outer.name, [0.0, 0.0])
                acc[0] += ms[0]
                acc[1] += ms[1]
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    return {"n": n, "stages": list(stages), "host_ms": host,
            "device_ms": device, "inside": inside, "busy_us": busy_us,
            "wall_us": wall_us,
            "idle_share": 1 - busy_us / wall_us if busy_us > 0 else None,
            "top_kernels": [
                (e.key, e.self_device_time_total / n)
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)
                [:top]]}


def split_lines(r, tag, what, name_width=48):
    """A `profiled` result as text: the stage split (a nested range in
    brackets after its enclosing one, a part of it and not a stage of its
    own), then the device's busy and idle share and its top kernels (µs a
    frame)."""
    n = r["n"]

    def item(k, host, device):
        parts = [item(c, *by[k]) for c, by in r["inside"].items() if k in by]
        return (f"{k} {host:.3f} / {device:.3f}" +
                (" [" + ", ".join(parts) + "]" if parts else ""))
    lines = [f"[{tag}] stage split of {what} (torch.profiler ranges, "
             "ms/frame host / device): " + ", ".join(
                 item(k, r["host_ms"][k], r["device_ms"][k])
                 for k in r["stages"] if k not in r["inside"])]
    if r["idle_share"] is None:
        lines.append(f"[{tag}] profiler: no device time recorded (not "
                     "measured)")
        return lines
    lines.append(
        f"[{tag}] profiler: device busy {r['busy_us'] / n:.1f} us/frame of "
        f"{r['wall_us'] / n:.1f} us/frame wall (idle share "
        f"{r['idle_share']:.3f}); top kernels: " + "; ".join(
            f"{k[:name_width]} {us:.1f} us" for k, us in r["top_kernels"]))
    return lines


def parser():
    p = argparse.ArgumentParser(
        description="Per-frame time of each stage of one chunk (the JAX "
                    "tool's eight figures) and a profiler split.")
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--model", default=None)
    p.add_argument("--encoder", default="mars")
    p.add_argument("--quantized", action="store_true")
    p.add_argument("--enc-cap", type=int, default=0,
                   help="crop+embed the first E detections (0 = all D, as "
                        "the JAX tool does)")
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None, framestep=None):
    """Times the figures, prints them and the profiler split, and prints
    the JSON line last. `framestep` replaces the FrameStep the flags would
    build."""
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(framestep.device if framestep is not None
                         else args.device)
    info = bench.device_info(dev)
    fs = framestep or bench.build_framestep(
        args.model, args.encoder, args.quantized, args.enc_cap, dev,
        args.height, args.width)
    chunk, reps = args.chunk, args.reps
    source = bench.SyntheticSource(chunk, chunk, fs.frame_h, fs.frame_w,
                                   use_yuv=False)
    frames = torch.from_numpy(source.chunk_at(0)).to(dev)
    bench.sync(dev)
    ms, _ = components(fs, frames, reps)
    per_frame = {k: float(np.median(v)) / chunk for k, v in ms.items()}
    print(f"chunk={chunk} per-frame ms (median of {reps}):")
    for k in FIGURES:
        print(f"  {LABELS[k]:<28} {per_frame[k]:.3f}")
    print(f"  (run_chunk = {1e3 / per_frame['run_chunk']:.1f} frames/s)")

    state = fs.init_state()
    fs.run_chunk(state, frames)
    bench.sync(dev)
    what = (f"run_chunk({chunk}), "
            f"{bench.family_name(args.model, args.quantized)}")
    split = profiled(lambda: fs.run_chunk(state, frames), chunk, dev)
    for line in split_lines(split, "profile", what, name_width=80):
        print(line)
    line = {
        "metric": f"per-frame ms by stage of one chunk ({what}, "
                  f"enc_cap={fs._enc_cap})",
        "value": per_frame["run_chunk"], "unit": "ms/frame",
        "stat": "median", "chunk": chunk, "reps": reps,
        "frame": [fs.frame_h, fs.frame_w],
        "figures_ms_per_frame": per_frame,
        "figures_ms_per_frame_min": {k: min(v) / chunk
                                     for k, v in ms.items()},
        "figures_ms_per_frame_max": {k: max(v) / chunk
                                     for k, v in ms.items()},
        "stage_host_ms_per_frame": split["host_ms"],
        "stage_device_ms_per_frame": split["device_ms"],
        "stage_inside_ms_per_frame": split["inside"],
        "busy_ms_per_frame": split["busy_us"] / chunk / 1e3,
        "wall_ms_per_frame": split["wall_us"] / chunk / 1e3,
        "idle_share": split["idle_share"],
        "top_kernels_ms_per_frame": [[k, us / 1e3]
                                     for k, us in split["top_kernels"]],
        **info}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
