"""Multi-stream batch processing CLI (BASELINE.json config 5).

Port of deepdish_tpu/tools/multistream_demo.py. Processes N videos
concurrently: the native C++ loader decodes all streams in parallel
threads, and the multi-stream engine (parallel/multistream.py) runs
detection + embedding for every stream's frames of a call in one forward
per device and each stream's tracker after it. Each stream keeps an
independent countline/counter state on the host.

Usage:
  python -m deepdish_tpu_torch.tools.multistream_demo --inputs a.mp4 b.mp4 \
      ... [--model ssd_mobilenet] [--encoder-model mars] \
      [--line x1,y1,x2,y2] [--width 1280 --height 720] \
      [--wanted-labels person] [--device cpu]

`--device` names the torch device; without it the streams are spread over
the cards present (and the demo raises when there is none).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def open_loader(paths, width, height):
    """The decoder the demo reads (S, F, H, W, 3) chunks from: the native
    multi-stream loader. Anything with `next_chunk(F)` -> (frames, counts,
    total) and `close()` may stand in for it."""
    from ..utils.native import NativeFrameLoader
    return NativeFrameLoader(paths, width, height)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--model", default="ssd_mobilenet")
    p.add_argument("--encoder-model", default="mars")
    p.add_argument("--wanted-labels", default="person")
    p.add_argument("--line", default=None)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--score-threshold", type=float, default=0.5)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--chunk", type=int, default=8,
                   help="frames per stream per call (one detector forward "
                        "over all of a device's streams' frames)")
    p.add_argument("--device", default=None,
                   help="torch device (e.g. cpu); default: every card")
    args = p.parse_args(argv)

    import torch
    from .. import tracker as tt
    from ..device import resolve_device, sync_numpy
    from ..models import create_box_encoder, create_detector
    from ..parallel import MultiStreamEngine, make_mesh
    from ..pipeline.counting import CountingState
    from ..pipeline.framestep import FrameStep, FrameStepConfig

    dev = resolve_device(args.device)
    wanted = args.wanted_labels.split(",")
    W, H = args.width, args.height
    det = create_detector(args.model, wanted_labels=wanted,
                          score_threshold=args.score_threshold, device=dev)
    enc = create_box_encoder(args.encoder_model, device=dev)
    cfg = tt.TrackerConfig(max_tracks=32, max_detections=16,
                           feature_dim=enc.feature_dim, gallery_size=64,
                           num_labels=max(len(wanted), 1))
    fs = FrameStep(det, enc, cfg, wanted, (H, W),
                   FrameStepConfig(score_threshold=args.score_threshold),
                   device=dev)
    S = len(args.inputs)
    # mesh size must divide the stream count; a named device is one device
    n_avail = torch.cuda.device_count() if args.device is None else 1
    n_dev = max(d for d in range(1, min(n_avail, S) + 1) if S % d == 0)
    mesh = make_mesh(n_dev, device=None if args.device is None else dev)
    eng = MultiStreamEngine(fs, n_streams=S, mesh=mesh)
    states = eng.init_states()

    if args.line:
        line = np.array(list(map(int, args.line.split(","))),
                        float).reshape(2, 2)
    else:
        line = np.array([[W / 2, 0], [W / 2, H]], float)
    counters = [CountingState(wanted, line) for _ in range(S)]

    loader = open_loader(args.inputs, W, H)
    total_frames = 0
    t0 = time.perf_counter()
    F = max(1, args.chunk)
    try:
        while True:
            frames, counts, got = loader.next_chunk(F)
            if got == 0:
                break
            if F == 1:
                states, outs, snaps = eng.step(states, frames[:, 0])
                outs_np = [sync_numpy(x, "outputs")[:, None] for x in outs]
            else:
                states, outs, snaps = eng.step_chunk(states, frames)
                outs_np = [sync_numpy(x, "outputs") for x in outs]
            for i in range(S):
                for k in range(int(counts[i])):
                    counters[i].process(
                        tt.TrackStepOutput(*(x[i, k] for x in outs_np)))
            total_frames += int(got)
            if args.max_frames and total_frames >= args.max_frames * S:
                break
    finally:
        loader.close()
    dt = time.perf_counter() - t0
    result = {
        "streams": S,
        "frames": total_frames,
        "fps_aggregate": round(total_frames / dt, 1),
        "per_stream": [c.counters_payload() for c in counters],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
