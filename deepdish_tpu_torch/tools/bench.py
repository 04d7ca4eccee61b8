"""Throughput and latency benchmark of the port on one card.

Port of the repository's bench.py (which drives deepdish_tpu on a TPU):
its three modes, flags and JSON line, on deepdish_tpu_torch.

  python -m deepdish_tpu_torch.tools.bench [--chunk 32] [--frames 640] \
      [--enc-cap 8] [--depth 2] [--model X] [--quantized] \
      [--encoder mars|mars_int8] [--synthetic] [--rgb] [--stripes 4] \
      [--seq-decode]
  python -m deepdish_tpu_torch.tools.bench --latency [--steps 200]
  python -m deepdish_tpu_torch.tools.bench --streams 16 [--stream-chunk 8] \
      [--e2e]

Modes, each printing one JSON line as the last line of standard output:
  chunked    FrameStep.run_chunk_yuv (run_chunk with --rgb) over chunks of
             --chunk 720p frames. `value` is the median per-chunk frames/s
             of the decode -> count loop, --depth chunks in flight (copies
             from pinned host buffers on a second CUDA stream, ordered by
             events); `device_resident_fps` times rounds of --reps chained
             calls on a chunk already on the card, each round ending in one
             host read; `transfer_ceiling_fps` a chunk copied to the card
             and consumed; `encode_overflow_dets` counts detections past
             the encode capacity. The mp4 source adds `decode_only_fps`,
             `decode_striped_fps` and `e2e_model_fps` (the least of the
             decode, transfer and device terms).
  --latency  FrameStep.step on one frame a call, each ending in a forced
             host read of track_id: p50/p90/p99 over --steps samples, with
             the frames already on the card (a ring of 8) and with a fresh
             host frame copied each step, beside the round trip of one
             trivial launch and a host read (`rtt_floor_ms`).
  --streams  MultiStreamEngine.step_chunk of N streams on a one-device mesh
             (bench.py's config 5 at N = 16): aggregate and per-stream
             frames/s with the frames staged on the card; --e2e decodes N
             mp4 files through the native loader instead and reports the
             decode, transfer and device terms.

Timing: the host clock around work that ends in a forced host read
(`device.sync_numpy`, which `device.host_syncs` counts) and a synchronize,
after a warm-up call (`warmup_s`: the first call, the kernels' nvcc build
included on a fresh machine). Each timed quantity is measured over ROUNDS
(5) timed units and reported as its median, with `_min`, `_max` and
`_rounds` beside it (`"stat": "median"`; bench.py reports the least of its
rounds as device_resident_fps). Beside each frame rate, `_window` is all
the frames of its timed units over all their seconds: the end-to-end
figure, which a stall in one unit moves and the median does not. Every
line carries the host
syncs, LSAP launches and detections a frame of its timed window, the
frames counted there, and the device: `"platform": "gpu"` with the card's
name, count and power limit, or `"platform": "cpu"` under --device cpu
(the plain PyTorch versions; no device name). `vs_baseline` is frames/s
over 1000, as in bench.py. Weights are random (seeded) unless --model
names a weight file.

Sources: --synthetic gives bench.py's in-memory frames (I420 by a numpy
BT.601 conversion, no cv2); otherwise an mp4 written by `make_video` (cv2)
is decoded by the native loader (utils/native.py). Without the loader the
tool raises, naming what is missing; it falls back to nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from collections import deque

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRACKER = dict(max_tracks=64, max_detections=32, gallery_size=64,
               num_labels=4)
WANTED = ("person", "car")
ROUNDS = 5                 # timed units of every quantity
RING = 8                   # --latency: frames staged on the card


# ---- devices, counters, statistics ----

def device_info(dev: torch.device) -> dict:
    """The JSON line's `platform` and `device` keys: the card's name
    (torch), count and power limit (nvidia-smi), or the CPU with no
    name."""
    if dev.type != "cuda":
        return {"platform": "cpu",
                "device": {"name": None, "count": 0, "power_limit_w": None}}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    limit = line.rsplit(",", 1)[1].split()[0]
    return {"platform": "gpu",
            "device": {"name": torch.cuda.get_device_name(0),
                       "count": torch.cuda.device_count(),
                       "power_limit_w": float(limit), "nvidia_smi": line}}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def read(dev: torch.device, t: torch.Tensor) -> np.ndarray:
    """The forced host read that ends a timed unit (one counted sync)."""
    from ..device import sync_numpy
    out = sync_numpy(t, "outputs")
    sync(dev)
    return out


def round_ms(dev: torch.device, chain, reps: int) -> float:
    """One timed round of `reps` chained dispatches: `chain(reps)` issues
    them and returns a tensor of the last. Milliseconds a dispatch, from
    CUDA events recorded around the chain on the card (the host clock on
    the CPU); the round ends in a forced host read of one element of that
    tensor (`read`)."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain(reps)
        end.record()
        read(dev, out.reshape(-1)[:1].float())
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    out = chain(reps)
    read(dev, out.reshape(-1)[:1].float())
    return (time.perf_counter() - t0) * 1e3 / reps


def interleaved_ms(dev: torch.device, legs: dict, rounds: int, reps: int):
    """legs {name: (step, x0)}: one warm-up call of each leg, then `rounds`
    rounds in which each leg in turn runs `reps` chained calls z = step(z)
    from x0 (`round_ms`; a step that ignores z times a fixed input).
    Returns ({name: [ms a call, per round]}, {name: the leg's last
    output})."""
    last = {}
    for name, (step, x0) in legs.items():
        last[name] = step(x0)
        sync(dev)
    times = {name: [] for name in legs}
    for _ in range(rounds):
        for name, (step, x0) in legs.items():
            def chain(n, step=step, x0=x0, name=name):
                z = x0
                for _ in range(n):
                    z = step(z)
                last[name] = z
                return z
            times[name].append(round_ms(dev, chain, reps))
    return times, last


class Counters:
    """Host syncs and LSAP launches from `start()` to `stop(frames)`."""

    def start(self):
        from .. import device as devmod
        from ..kernels import lsap
        devmod.host_syncs = 0
        lsap.launches = 0

    def stop(self, frames: int) -> dict:
        from .. import device as devmod
        from ..kernels import lsap
        return {"frames": frames,
                "host_syncs_per_frame": devmod.host_syncs / frames,
                "lsap_launches_per_frame": lsap.launches / frames,
                "lsap_launches": lsap.launches}


def spread(key: str, values) -> dict:
    """{key: median, key_min, key_max, key_rounds}."""
    v = [float(x) for x in values]
    return {key: float(np.median(v)), f"{key}_min": min(v),
            f"{key}_max": max(v), f"{key}_rounds": v}


def rate(key: str, frames: int, seconds) -> dict:
    """Frames/s of timed units of `frames` frames each, taking `seconds`:
    `spread` of the units' rates, and `key_window`, all their frames over
    all their seconds."""
    return {**spread(key, [frames / t for t in seconds]),
            f"{key}_window": frames * len(seconds) / sum(seconds)}


def percentiles(ms) -> dict:
    ms = np.asarray(ms, np.float64)
    return {"p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90)),
            "p99": float(np.percentile(ms, 99)),
            "min": float(ms.min()), "max": float(ms.max()),
            "mean": float(ms.mean()), "n": int(ms.size)}


# ---- frames (bench.py's formulas) ----

def base_image(h: int, w: int) -> np.ndarray:
    """bench.py's dark background: the seed-0 draw every mode starts
    from."""
    return np.random.RandomState(0).randint(0, 80, size=(h, w, 3)).astype(
        np.uint8)


def latency_frame(base: np.ndarray, i: int) -> np.ndarray:
    """bench.py:358-362: frame i of the latency mode."""
    f = base.copy()
    x = (40 + i * 9) % (base.shape[1] - 200)
    f[200:500, x:x + 160] = 230
    return f


def chunk_frame(base: np.ndarray, k: int) -> np.ndarray:
    """bench.py:598-602 (and tools/profile_components.py:42-45): frame k of
    the chunked mode's synthetic source, counted over all chunks."""
    f = base.copy()
    x = (40 + k * 24) % (base.shape[1] - 200)
    f[200:500, x:x + 160] = 230
    return f


def stream_frames(n_streams: int, chunk: int, h: int, w: int) -> np.ndarray:
    """bench.py:270-278: (S, F, H, W, 3), stream s's block offset s * 60
    px."""
    base = base_image(h, w)
    frames = np.zeros((n_streams, chunk, h, w, 3), np.uint8)
    for s in range(n_streams):
        for k in range(chunk):
            f = base.copy()
            x = (40 + s * 60 + k * 9) % (w - 200)
            f[200:500, x:x + 160] = 230
            frames[s, k] = f
    return frames


def to_i420(frames_rgb: np.ndarray) -> np.ndarray:
    """(F, H, W, 3) RGB -> (F, H*3/2, W) I420 with BT.601 video-range
    coefficients, in numpy (no cv2)."""
    f = frames_rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    F_, H, W = y.shape
    sub = (lambda c: c.reshape(F_, H // 2, 2, W // 2, 2).mean((2, 4))
           .reshape(F_, H // 4, W))
    out = np.concatenate([y, sub(u), sub(v)], axis=1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class SyntheticSource:
    """bench.py's in-memory chunks (`synth_chunk`): frame k of the run is
    `chunk_frame(base, k)`, I420 unless `use_yuv` is off. The block's
    position repeats, so each distinct frame is made (and converted) once
    and a chunk is stacked from them."""

    def __init__(self, chunk, total_frames, h, w, use_yuv):
        self.chunk, self.total = chunk, total_frames
        self.use_yuv = use_yuv
        self.base = base_image(h, w)
        self._frames = {}

    def frame(self, k: int) -> np.ndarray:
        x = (40 + k * 24) % (self.base.shape[1] - 200)
        if x not in self._frames:
            f = chunk_frame(self.base, k)
            self._frames[x] = to_i420(f[None])[0] if self.use_yuv else f
        return self._frames[x]

    def chunk_at(self, i: int) -> np.ndarray:
        return np.stack([self.frame(i * self.chunk + j)
                         for j in range(self.chunk)])

    def next_chunk(self, i: int):
        return self.chunk_at(i) if i * self.chunk < self.total else None

    def close(self):
        pass


def make_video(path, n_frames, h, w, phase=0):
    """bench.py:86-102: the synthetic scene with two moving rectangles as an
    mp4 (cv2's writer); `phase` offsets the motion per stream."""
    import cv2
    four = cv2.VideoWriter_fourcc(*"mp4v")
    wr = cv2.VideoWriter(path, four, 30, (w, h))
    rng = np.random.RandomState(phase)
    base = rng.randint(0, 80, size=(h, w, 3)).astype(np.uint8)
    for i in range(n_frames):
        f = base.copy()
        x = (40 + phase * 60 + i * 9) % (w - 200)
        y = (30 + phase * 40 + i * 5) % (h - 400)
        f[200:500, x:x + 160] = 230
        f[y:y + 220, 900:1020] = 180
        wr.write(f)
    wr.release()


def loader_problem():
    """None when the native frame loader (native/libframeloader.so) loads,
    building it first if it is missing; else what is missing, in words."""
    from ..utils import native
    try:
        if native.load_library() is not None:
            return None
    except OSError as e:
        return f"{native._LIB_PATH} does not load ({e})"
    missing = []
    if shutil.which("g++") is None:
        missing.append("g++")
    if shutil.which("make") is None:
        missing.append("make")
    if not os.path.isdir("/usr/include/opencv4"):
        missing.append("OpenCV's headers (/usr/include/opencv4)")
    return ("the native frame loader does not build: "
            + (", ".join(missing) + " missing" if missing else
               f"`make -C {os.path.dirname(native._LIB_PATH)}` failed"))


def require_loader():
    problem = loader_problem()
    if problem is not None:
        raise RuntimeError(f"the mp4 source needs the native frame loader: "
                           f"{problem}; pass --synthetic for in-memory "
                           "frames")
    try:
        import cv2  # noqa: F401  (make_video writes the mp4 with it)
    except ImportError as e:
        raise RuntimeError(f"the mp4 source writes its video with OpenCV "
                           f"(cv2), which does not import ({e}); pass "
                           "--synthetic") from e


def video_path(video_dir, name, n_frames, h, w, phase=0):
    path = os.path.join(video_dir,
                        f".bench_{name}_{n_frames}_{h}x{w}_{phase}.mp4")
    if not os.path.exists(path):
        make_video(path, n_frames, h, w, phase=phase)
    return path


# ---- host -> card transfers ----

class Uploader:
    """Host chunks of one shape -> device tensors with `depth` of them in
    flight: a chunk is copied into one of depth + 1 pinned host buffers,
    all allocated here (before any timing), and from there to the card by
    a non_blocking copy on a side stream; `take` makes the compute stream
    wait for that copy's event. On the CPU a chunk is used as it is."""

    def __init__(self, dev: torch.device, depth: int, shape):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.shape = tuple(shape)
        self.bufs = ([torch.empty(self.shape, dtype=torch.uint8,
                                  pin_memory=True)
                      for _ in range(depth + 1)] if self.cuda else [])
        self.done = [None] * len(self.bufs)
        self.next = 0
        self.stream = torch.cuda.Stream(dev) if self.cuda else None

    def put(self, host: np.ndarray):
        if not self.cuda:
            return torch.from_numpy(host), None
        if host.shape != self.shape:
            raise ValueError(f"chunk of shape {host.shape}, buffers of "
                             f"{self.shape}")
        slot = self.next % len(self.bufs)
        self.next += 1
        buf = self.bufs[slot]
        if self.done[slot] is not None:
            self.done[slot].synchronize()   # the last copy out of `buf`
        buf.numpy()[...] = host
        with torch.cuda.stream(self.stream):
            dev_t = buf.to(self.dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.done[slot] = ev
        return dev_t, ev

    def take(self, item) -> torch.Tensor:
        t, ev = item
        if ev is not None:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_event(ev)
            t.record_stream(cur)
        return t


def transfer_times(dev, up: Uploader, host: np.ndarray):
    """Seconds of each of ROUNDS copies of `host` to the card through `up`,
    each consumed there (a strided sample summed on the device and read by
    the host), after one untimed copy through each of `up`'s buffers (as
    bench.py warms its consumer first)."""
    def once():
        t = up.take(up.put(host))
        read(dev, t.reshape(-1)[::4096].float().sum())

    for _ in range(max(1, len(up.bufs))):
        once()
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return times


def resident_times(dev, call, state, frames, reps: int):
    """ROUNDS rounds of `reps` chained `state, outs, _ = call(state,
    frames)` on frames already on the card, each round ending in one host
    read: (seconds a call in each round, the last state)."""
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(reps):
            state, outs, _ = call(state, frames)
        read(dev, outs.track_id)
        times.append((time.perf_counter() - t0) / reps)
    return times, state


# ---- building ----

def family_name(model, quantized=False) -> str:
    """bench.py's family label for the metric."""
    fam = (model or "ssd_mobilenet").lower()
    name = ("YOLOv5s" if "yolov5" in fam else
            "YOLOv3" if "yolo" in fam else
            "Faster-RCNN" if ("faster_rcnn" in fam or "frcnn" in fam) else
            "EfficientDet-Lite0" if ("efficientdet" in fam or
                                     ("tflite" in fam and "ssd" not in fam
                                      and "mobilenet" not in fam
                                      and "edgetpu" not in fam)) else
            "SSD-MobileNet")
    return name + ("-int8" if quantized else "")


def build_framestep(model=None, encoder="mars", quantized=False, enc_cap=8,
                    device=None, height=720, width=1280, tracker=None,
                    wanted=WANTED):
    """bench.py's FrameStep: `--model` (a family name or a weight file,
    through models.registry.create_detector; max_outputs 32), the
    encoder, tracker T = 64, D = 32, G = 64, four labels, labels person
    and car, encode capacity `enc_cap`."""
    from .. import tracker as tt
    from ..device import resolve_device
    from ..models import create_box_encoder, create_detector
    from ..pipeline import FrameStep, FrameStepConfig
    dev = resolve_device(device)
    det = create_detector(model or "ssd_mobilenet", max_outputs=32,
                          quantized=quantized, device=dev)
    enc = create_box_encoder(encoder, device=dev)
    cfg = tt.TrackerConfig(**(tracker or TRACKER))
    return FrameStep(det, enc, cfg, list(wanted), (height, width),
                     FrameStepConfig(encode_capacity=enc_cap), device=dev)


# ---- --latency ----

def bench_latency(fs, steps=200, what="SSD-MobileNet+MARS+DeepSORT"):
    """bench.py:328-431 on FrameStep.step. Returns (JSON line, detail)."""
    dev = fs.device
    base = base_image(fs.frame_h, fs.frame_w)
    state = fs.init_state()
    t0 = time.perf_counter()
    state, out, _, _ = fs.step(state, latency_frame(base, 0))
    read(dev, out.track_id)
    warmup_s = time.perf_counter() - t0

    ring = [torch.from_numpy(latency_frame(base, i)).to(dev)
            for i in range(RING)]
    sync(dev)
    counters = Counters()
    counters.start()
    dets = torch.zeros((), dtype=torch.int64, device=dev)
    res_ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, out, snap, _ = fs.step(state, ring[i % RING])
        read(dev, out.track_id)
        res_ms.append((time.perf_counter() - t0) * 1e3)
        dets += snap.valid.sum()
    e2e_ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, out, snap, _ = fs.step(state, latency_frame(base, i))
        read(dev, out.track_id)
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
        dets += snap.valid.sum()
    counts = counters.stop(2 * steps)

    tiny = torch.zeros((8,), dtype=torch.int32, device=dev)
    read(dev, tiny + 1)
    rtt_ms = []
    for _ in range(min(steps, 50)):
        t0 = time.perf_counter()
        read(dev, tiny + 1)
        rtt_ms.append((time.perf_counter() - t0) * 1e3)
    res = percentiles(res_ms)
    line = {
        "metric": f"720p serving latency p50 single-frame step ({what}, "
                  f"enc_cap={fs._enc_cap}, device-resident, 1 card)",
        "value": res["p50"], "unit": "ms",
        "vs_baseline": (1000.0 / res["p50"]) / 1000.0,
        "stat": "percentiles of single-step samples",
        "resident_ms": res, "e2e_ms": percentiles(e2e_ms),
        "rtt_floor_ms": percentiles(rtt_ms), "steps": steps,
        "frame": [fs.frame_h, fs.frame_w], "warmup_s": warmup_s,
        "dets_per_frame": float(read(dev, dets)) / (2 * steps), **counts}
    return line, {"state": state, "resident_ms": res_ms, "e2e_ms": e2e_ms}


# ---- chunked ----

def _decode_fps(make, get, n_probe):
    """Frames a second of a loader drained for n_probe frames, timed from
    its construction (thread spin-up included), with no device work."""
    t0 = time.perf_counter()
    ld = make()
    got = 0
    try:
        while got < n_probe:
            g = get(ld)
            if g == 0:
                break
            got += g
    finally:
        ld.close()
    return got / (time.perf_counter() - t0)


class _LoaderSource:
    """A native loader's chunks ((F, ...) of one stream, or (S, F, ...) of
    all with `streams`); a partial tail ends the run."""

    def __init__(self, loader, chunk, streams=False):
        self.loader, self.chunk, self.streams = loader, chunk, streams

    def next_chunk(self, i):
        frames, counts, _ = self.loader.next_chunk(self.chunk)
        if int(np.min(counts)) != self.chunk:
            return None
        return frames if self.streams else frames[0]

    def close(self):
        self.loader.close()


def decode_count(dev, step, init_state, source, chunk, streams,
                 total_frames, depth, reps, enc_cap):
    """The decode -> count pipeline of the chunked mode and of --streams
    --e2e. `step(state, frames)` is the FrameStep's or the engine's call on
    one chunk (`chunk` frames of each of `streams` streams) from
    `source.next_chunk(i)`. A warm-up call on chunk 0; ROUNDS copies of
    it to the card (`transfer_times`); from a fresh state, calls on chunks
    0, 1, ... (a synthetic source restarts, a loader goes on) until
    `total_frames` frames a stream are counted, `depth` chunks in flight,
    each call ending in a forced host read; then ROUNDS rounds of `reps`
    chained calls on chunk 0 on the card. Closes the source. Returns (the
    line's timing and counter keys, the last call's track ids)."""
    per_call = chunk * streams
    try:
        first = source.next_chunk(0)
        t0 = time.perf_counter()
        _, outs, _ = step(init_state(), torch.from_numpy(first).to(dev))
        read(dev, outs.track_id)
        warmup_s = time.perf_counter() - t0
        up = Uploader(dev, depth, first.shape)
        ttimes = transfer_times(dev, up, first)

        state = init_state()
        q = deque()
        i = 0
        while len(q) < depth:
            host = source.next_chunk(i)
            i += 1
            if host is None:
                break
            q.append(up.put(host))
        counters = Counters()
        counters.start()
        dets = torch.zeros((), dtype=torch.int64, device=dev)
        times, overflow, n_done, ids = [], 0, 0, None
        while n_done < total_frames and q:
            t0 = time.perf_counter()
            cur = up.take(q.popleft())
            host = source.next_chunk(i)
            i += 1
            if host is not None:
                q.append(up.put(host))
            state, outs, snaps = step(state, cur)
            dets += snaps.valid.sum()
            ids = read(dev, outs.track_id)
            valid = read(dev, snaps.valid)
            times.append(time.perf_counter() - t0)
            overflow += int(valid[..., enc_cap:].sum())
            n_done += chunk
        counts = counters.stop(n_done * streams)
    finally:
        source.close()
    rtimes, _ = resident_times(dev, step, state,
                               torch.from_numpy(first).to(dev), reps)
    line = {**rate("value", per_call, times), "unit": "frames/s",
            "stat": "median", **rate("device_resident_fps", per_call, rtimes),
            **rate("transfer_ceiling_fps", per_call, ttimes),
            "encode_overflow_dets": overflow, "depth": depth,
            "rounds": ROUNDS, "reps": reps, "warmup_s": warmup_s,
            "dets_per_frame": float(read(dev, dets)) / counts["frames"],
            **counts}
    line["vs_baseline"] = line["value"] / 1000.0
    return line, ids


def bench_chunked(fs, chunk=32, total_frames=640, depth=2, reps=16,
                  use_yuv=True, synthetic=False, stripes=4,
                  seq_decode=False, video_dir=ROOT,
                  what="SSD-MobileNet+MARS+DeepSORT"):
    """bench.py:465-751 on FrameStep.run_chunk_yuv / run_chunk. Returns
    (JSON line, detail)."""
    dev = fs.device
    H, W = fs.frame_h, fs.frame_w
    decode_only = decode_striped = None
    if synthetic:
        source = SyntheticSource(chunk, total_frames, H, W, use_yuv)
        src = "synthetic"
    else:
        require_loader()
        from ..utils.native import NativeFrameLoader, StripedFrameLoader
        n_video = total_frames + (depth + 1) * chunk
        video = video_path(video_dir, "video", n_video, H, W)
        n_probe = min(total_frames, 8 * chunk)

        def sequential():
            return NativeFrameLoader([video], W, H, yuv420=use_yuv)

        def striped():
            return StripedFrameLoader(video, n_workers=stripes,
                                      stripe_len=64, out_w=W, out_h=H,
                                      yuv420=use_yuv)
        decode_only = _decode_fps(sequential,
                                  lambda ld: ld.next_chunk(chunk)[2], n_probe)
        decode_striped = _decode_fps(striped, lambda ld: ld.next(chunk)[0],
                                     n_probe)
        seq_decode = seq_decode or decode_striped <= decode_only
        source = _LoaderSource(sequential() if seq_decode else striped(),
                               chunk)
        src = ("mp4-native-decode" if seq_decode else
               f"mp4-striped-decode-x{stripes}")
    timing, ids = decode_count(
        dev, fs.run_chunk_yuv if use_yuv else fs.run_chunk, fs.init_state,
        source, chunk, 1, total_frames, depth, reps, fs._enc_cap)
    decode = decode_only if seq_decode else decode_striped
    line = {
        "metric": f"720p offline FPS decode->count ({what}, chunk={chunk}"
                  f"{', yuv' if use_yuv else ''}, enc_cap={fs._enc_cap}, "
                  f"depth={depth}, src={src}, 1 card)",
        **timing, "transport": "yuv" if use_yuv else "rgb",
        "decode_only_fps": decode_only, "decode_striped_fps": decode_striped,
        "decode_stripes": 1 if (synthetic or seq_decode) else stripes,
        "e2e_model_fps": (None if decode is None else min(
            decode, timing["transfer_ceiling_fps"],
            timing["device_resident_fps"])),
        "chunk": chunk, "source": src, "frame": [H, W]}
    return line, {"track_id": ids}


# ---- --streams ----

def bench_streams(eng, chunks, reps=16, what="SSD-MobileNet+MARS+DeepSORT"):
    """bench.py:237-326: MultiStreamEngine.step_chunk on frames staged on
    the card (`chunks`: a list of (S, F, H, W, 3) device tensors): a
    warm-up call on the first, then ROUNDS rounds of `reps` calls on the
    next ones in turn (cycling), each round ending in one host read.
    Returns (JSON line, detail with the states and the last outputs)."""
    dev = eng.out_device
    S, F = chunks[0].shape[:2]
    states = eng.init_states()
    t0 = time.perf_counter()
    states, outs, _ = eng.step_chunk(states, chunks[0])
    read(dev, outs.track_id)
    warmup_s = time.perf_counter() - t0

    counters = Counters()
    counters.start()
    dets = torch.zeros((), dtype=torch.int64, device=dev)
    rtimes, c = [], 0
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(reps):
            c += 1
            states, outs, snaps = eng.step_chunk(states,
                                                 chunks[c % len(chunks)])
            dets += snaps.valid.sum()
        read(dev, outs.track_id)
        rtimes.append((time.perf_counter() - t0) / reps)
    counts = counters.stop(ROUNDS * reps * S * F)
    agg = rate("value", S * F, rtimes)
    line = {
        "metric": f"multi-stream aggregate 720p FPS ({S} streams, "
                  f"chunk={F}/stream, {what}, device-resident, 1 card)",
        **agg, "unit": "frames/s", "vs_baseline": agg["value"] / 1000.0,
        "stat": "median", **rate("per_stream_fps", F, rtimes),
        **spread("ms_per_call", [t * 1e3 for t in rtimes]),
        "streams": S, "stream_chunk": F, "rounds": ROUNDS, "reps": reps,
        "enc_cap": eng.fs._enc_cap, "frame": [eng.fs.frame_h, eng.fs.frame_w],
        "warmup_s": warmup_s,
        "dets_per_frame": float(read(dev, dets)) / counts["frames"],
        **counts}
    return line, {"states": states, "outs": outs, "snaps": snaps}


def bench_streams_e2e(eng, chunk=8, depth=2, total_frames=256, reps=8,
                      use_yuv=True, video_dir=ROOT,
                      what="SSD-MobileNet+MARS+DeepSORT"):
    """bench.py:105-235: N mp4 streams decoded by the native loader (one
    file a stream, each on its own thread), `chunk` frames a stream a call
    shipped to the card; the decode ceiling, the transfer ceiling and the
    device-resident aggregate beside the e2e value. Returns (JSON line,
    detail)."""
    require_loader()
    from ..utils.native import NativeFrameLoader
    fs, dev, S = eng.fs, eng.out_device, eng.n_streams
    H, W = fs.frame_h, fs.frame_w
    n_video = total_frames + (depth + 1) * chunk
    paths = [video_path(video_dir, "ms", n_video, H, W, phase=s)
             for s in range(S)]
    n_probe = max(2, min(total_frames, 4 * chunk) // chunk)
    decode_only = _decode_fps(
        lambda: NativeFrameLoader(paths, W, H, yuv420=use_yuv),
        lambda ld: ld.next_chunk(chunk)[2], n_probe * chunk * S)
    source = _LoaderSource(NativeFrameLoader(paths, W, H, yuv420=use_yuv),
                           chunk, streams=True)
    timing, _ = decode_count(
        dev, eng.step_chunk_yuv if use_yuv else eng.step_chunk,
        eng.init_states, source, chunk, S, total_frames, depth, reps,
        fs._enc_cap)
    line = {
        "metric": f"multi-stream e2e decode->count aggregate 720p FPS "
                  f"({S} streams, chunk={chunk}/stream"
                  f"{', yuv' if use_yuv else ''}, enc_cap={fs._enc_cap}, "
                  f"depth={depth}, {what}, native mp4 decode, 1 card)",
        **timing, "per_stream_fps": timing["value"] / S,
        "decode_only_fps": decode_only,
        "e2e_model_fps": min(decode_only, timing["transfer_ceiling_fps"],
                             timing["device_resident_fps"]),
        "transport": "yuv" if use_yuv else "rgb", "streams": S,
        "stream_chunk": chunk, "frame": [H, W]}
    return line, {}


# ---- CLI ----

def parser():
    p = argparse.ArgumentParser(
        description="Throughput and latency of the port on one card "
                    "(bench.py's modes).")
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--frames", type=int, default=None,
                   help="frames to process (default 640; 256 a stream "
                        "with --streams --e2e)")
    p.add_argument("--enc-cap", type=int, default=8)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--model", default=None)
    p.add_argument("--quantized", action="store_true")
    p.add_argument("--encoder", default="mars")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--rgb", action="store_true")
    p.add_argument("--stripes", type=int, default=4)
    p.add_argument("--seq-decode", action="store_true")
    p.add_argument("--latency", action="store_true")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--streams", type=int, default=None)
    p.add_argument("--stream-chunk", type=int, default=8)
    p.add_argument("--e2e", action="store_true")
    p.add_argument("--reps", type=int, default=None,
                   help="chained calls a device-resident round (default 16; "
                        "8 with --streams --e2e)")
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    p.add_argument("--video-dir", default=ROOT,
                   help="where the mp4 sources are written")
    return p


def main(argv=None, framestep=None):
    """Runs the mode the flags select and prints its JSON line last.
    `framestep` replaces the FrameStep the flags would build (its device,
    frame size, networks and tracker are then the run's)."""
    args = parser().parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(framestep.device if framestep is not None
                         else args.device)
    info = device_info(dev)
    fs = framestep or build_framestep(
        args.model, args.encoder, args.quantized, args.enc_cap, dev,
        args.height, args.width)
    enc_label = "MARS" if args.encoder == "mars" else args.encoder
    what = f"{family_name(args.model, args.quantized)}+{enc_label}+DeepSORT"
    depth = max(1, args.depth)
    if args.streams is not None:
        from ..parallel import MultiStreamEngine, make_mesh
        eng = MultiStreamEngine(fs, n_streams=args.streams,
                                mesh=make_mesh(1, device=dev))
        if args.e2e:
            line, _ = bench_streams_e2e(
                eng, args.stream_chunk, depth, args.frames or 256,
                args.reps or 8, not args.rgb, args.video_dir, what)
        else:
            frames = stream_frames(args.streams, args.stream_chunk,
                                   fs.frame_h, fs.frame_w)
            line, _ = bench_streams(eng, [torch.from_numpy(frames).to(dev)],
                                    args.reps or 16, what)
    elif args.latency:
        line, _ = bench_latency(fs, args.steps, what)
    else:
        line, _ = bench_chunked(
            fs, args.chunk, args.frames or 640, depth, args.reps or 16,
            not args.rgb, args.synthetic, args.stripes, args.seq_decode,
            args.video_dir, what)
    line.update(info)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
