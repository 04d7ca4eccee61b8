"""FLOPs a frame of the chunk program the bench measures, and the MFU at a
frame rate, on one card.

Port of the repository's tools/flops_report.py (which reads XLA's cost
analysis of the JAX program). Builds bench.py's FrameStep
(`bench.build_framestep`: 720p, tracker T = 64, D = 32, G = 64, labels
person and car, encode capacity --enc-cap) and runs one
`run_chunk_yuv` of --chunk frames of zeros under `utils.flops.Count`:
2 x the multiply-adds of every convolution and matrix product on the
path, at the shapes it runs them (the detector at batch `chunk`, MARS over
chunk x enc_cap crops, the tracker's distance and Kalman products, the
integer executor's int8 products under --quantized). The count does not
depend on the implementation (utils/flops.py): the card's count equals
the CPU's. Elementwise work is not counted (XLA's "flops", which the JAX
tool reads, counts it too and costs convolutions its own way, so the two
figures differ). Then the same program stage by stage
(detector: I420 conversion, resize, network, decode and NMS; MARS: crop
and encoder; tracker: `tracker.step` over the chunk), whose counts sum to
the whole.

  python -m deepdish_tpu_torch.tools.flops_report [--chunk 32] \
      [--enc-cap 8] [--fps F] [--model ssd_mobilenet|yolov5|yolov3|
      efficientdet|faster_rcnn|FILE] [--quantized] [--device cuda]

With --fps, the rate F x FLOPs a frame and its share of the H100 SXM's
dense peak for the detector's arithmetic: 989 TFLOP/s bf16 (the card's
default), 1,979 TOP/s int8 under --quantized, 67 TFLOP/s float32 (the
parity configuration, TF32 off: device.py). Prints GFLOP a dispatch and a
frame by stage, then one JSON line last with the exact integer counts and
the bench's `platform` and `device` keys (the card's name and power
limit).
"""
from __future__ import annotations

import argparse
import json

import torch

from ..utils import flops
from . import bench

# H100 SXM dense peaks, operations a second
PEAKS = {"bf16": 989e12, "int8": 1979e12, "float32": 67e12}
STAGES = ("detector", "mars", "tracker")


def peak_kind(fs, quantized: bool) -> str:
    """The peak the detector's contractions run against: int8 for the
    integer executor, else the detector's compute dtype."""
    if quantized:
        return "int8"
    dt = getattr(fs.detector, "compute_dtype", torch.float32)
    return "bf16" if dt == torch.bfloat16 else "float32"


@torch.inference_mode()
def count(fs, chunk: int) -> dict:
    """Exact FLOPs of one `run_chunk_yuv` of `chunk` zero I420 frames on
    fs's device (from a fresh state): {"total", "stages": {detector, mars,
    tracker}, "by_op"}, integers."""
    from .. import tracker as tt
    from ..ops import colorspace
    from .profile_components import crop_mars, tracker_scan
    H, W = fs.frame_h, fs.frame_w
    yuv = torch.zeros((chunk, H * 3 // 2, W), dtype=torch.uint8,
                      device=fs.device)
    with flops.Count() as whole:
        fs.run_chunk_yuv(fs.init_state(), yuv)
    with flops.Count() as det:
        frames = colorspace.yuv420_to_rgb_u8(yuv, H, W)
        snaps = fs._filter_and_nms(None, *fs._detect_raw(frames))
    with flops.Count() as mars:
        feats = crop_mars(fs, frames, snaps)
    dets = tt.Detections(tlwh=snaps.tlwh, confidence=snaps.score,
                         label=snaps.label,
                         feature=fs._pad_features(feats), valid=snaps.valid)
    with flops.Count() as trk:
        tracker_scan(fs, fs.init_state().table, dets)
    return {"total": whole.total,
            "stages": {"detector": det.total, "mars": mars.total,
                       "tracker": trk.total},
            "by_op": whole.by_op()}


def parser():
    p = argparse.ArgumentParser(
        description="FLOPs a frame of the port's chunk program, and MFU.")
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--enc-cap", type=int, default=8)
    p.add_argument("--fps", type=float, default=None,
                   help="frames a second to turn the count into a rate")
    p.add_argument("--model", default="ssd_mobilenet")
    p.add_argument("--quantized", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None, framestep=None):
    """Counts, prints, and returns the JSON line. `framestep` replaces the
    FrameStep the flags would build."""
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(framestep.device if framestep is not None
                         else args.device)
    info = bench.device_info(dev)
    fs = framestep or bench.build_framestep(
        args.model, "mars", args.quantized, args.enc_cap, dev)
    chunk = args.chunk
    c = count(fs, chunk)
    per_frame = c["total"] / chunk
    what = f"{bench.family_name(args.model, args.quantized)}+MARS+DeepSORT"
    print(f"chunk={chunk} enc_cap={fs._enc_cap} ({what}, "
          f"{fs.frame_h}x{fs.frame_w}, {dev.type}): "
          f"{c['total'] / 1e9:.3f} GFLOP/dispatch = {per_frame / 1e9:.4f} "
          f"GFLOP/frame")
    for s in STAGES:
        print(f"  {s:9s} {c['stages'][s] / chunk / 1e9:10.4f} GFLOP/frame")
    for op, n in sorted(c["by_op"].items()):
        print(f"  {op:22s} {n / 1e9:10.3f} GFLOP/dispatch")
    kind = peak_kind(fs, args.quantized)
    line = {"metric": f"FLOPs a frame of run_chunk_yuv ({what}, "
                      f"chunk={chunk}, enc_cap={fs._enc_cap})",
            "value": per_frame / 1e9, "unit": "GFLOP/frame",
            "flops_per_dispatch": c["total"],
            "stage_flops_per_dispatch": c["stages"],
            "op_flops_per_dispatch": c["by_op"],
            "gflop_per_frame": {s: c["stages"][s] / chunk / 1e9
                                for s in STAGES},
            "chunk": chunk, "enc_cap": fs._enc_cap,
            "frame": [fs.frame_h, fs.frame_w], "peak": kind,
            "peak_tflops": PEAKS[kind] / 1e12, "fps": args.fps}
    if args.fps:
        rate = per_frame * args.fps
        line.update(tflops=rate / 1e12, mfu=rate / PEAKS[kind])
        card = info["device"]
        where = (f"{card['name']}, {card['power_limit_w']:.2f} W"
                 if card["name"] else "no card: run on the CPU")
        print(f"at {args.fps:.2f} frames/s: {rate / 1e12:.4f} TFLOP/s = "
              f"{100 * rate / PEAKS[kind]:.4f}% of the H100's "
              f"{PEAKS[kind] / 1e12:.0f} T{'OP' if kind == 'int8' else 'FLOP'}"
              f"/s dense {kind} ({where})")
    line.update(info)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
