"""Decode-ceiling probe: sequential against keyframe-striped decode of one
file, on the host.

Port of the repository's tools/decode_probe.py. The offline decode ->
count rate is the least of the decode, transfer and device terms; this
measures the DECODE term of the host as a stripe-count curve: the native
sequential loader (utils/native.py `NativeFrameLoader`, one decoder)
against the striped decoder (`StripedFrameLoader`: K decoder threads over
interleaved frame stripes of one file, byte-equal output). No card work:
--device only names the device in the JSON line (the bench's `platform`
and `device` keys), and without a card the tool raises unless given
--device cpu, as the port's other tools do.

The loader is native/libframeloader.so (g++, make and OpenCV's headers
and libraries build it). Where it neither loads nor builds, as on a host
without OpenCV, the tool raises with `bench.loader_problem`'s words; it
falls back to nothing.

  python -m deepdish_tpu_torch.tools.decode_probe [--video F] \
      [--frames N] [--yuv] [--stripes 1,2,4,8] [--stripe-len 64] \
      [--width 1280] [--height 720] [--device cuda]

Without --video it writes a synthetic 720p mp4 (cv2) into a temporary
directory. Prints one JSON line: the JAX tool's keys (`video`, `frames`,
`transport`, `stripe_len`, `decode_only_fps`, `striped_fps_by_workers`,
`host_cores`) and the bench's `platform` and `device` keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from . import bench


def make_video(path, n, h, w):
    """The JAX tool's synthetic clip: a dark noise background and one
    bright block moving 24 px a frame, mp4v at 30 frames/s."""
    import cv2
    rng = np.random.RandomState(0)
    base = rng.randint(0, 80, size=(h, w, 3)).astype(np.uint8)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for i in range(n):
        f = base.copy()
        x = (40 + i * 24) % (w - 200)
        f[h // 4:3 * h // 4, x:x + 160] = 230
        vw.write(f)
    vw.release()


def parser():
    ap = argparse.ArgumentParser(
        description="Sequential against striped decode of one file.")
    ap.add_argument("--video", default=None,
                    help="mp4 to probe (default: synthesize 720p)")
    ap.add_argument("--frames", type=int, default=256,
                    help="frames to drain per leg")
    ap.add_argument("--yuv", action="store_true",
                    help="planar I420 output (the bench transport)")
    ap.add_argument("--stripes", default="1,2,4,8")
    ap.add_argument("--stripe-len", type=int, default=64)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--device", default="cuda",
                    help="the device the JSON line names; cpu without a "
                         "card")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from ..device import resolve_device
    info = bench.device_info(resolve_device(args.device))
    problem = bench.loader_problem()
    if problem is not None:
        raise RuntimeError(f"decode_probe needs the native frame loader: "
                           f"{problem}")
    from ..utils.native import NativeFrameLoader, StripedFrameLoader
    n, W, H = args.frames, args.width, args.height
    with tempfile.TemporaryDirectory() as tmp:
        video = args.video
        if video is None:
            video = os.path.join(tmp, f".decode_probe_{n}.mp4")
            make_video(video, n + 16, H, W)
        seq = bench._decode_fps(
            lambda: NativeFrameLoader([video], W, H, yuv420=args.yuv),
            lambda ld: ld.next_chunk(32)[2], n)
        curve = {}
        for k in (int(x) for x in args.stripes.split(",")):
            curve[k] = round(bench._decode_fps(
                lambda: StripedFrameLoader(video, n_workers=k,
                                           stripe_len=args.stripe_len,
                                           out_w=W, out_h=H,
                                           yuv420=args.yuv),
                lambda ld: ld.next(32)[0], n), 1)
    print(json.dumps({
        "video": os.path.basename(video), "frames": n,
        "transport": "yuv" if args.yuv else "rgb",
        "stripe_len": args.stripe_len,
        "decode_only_fps": round(seq, 1),
        "striped_fps_by_workers": curve,
        "host_cores": os.cpu_count(), **info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
