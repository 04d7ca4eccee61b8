#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (deepdish_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100, sm_90a), nvcc and scipy. Phases, each fatal on
failure:

  1. build   every kernel in deepdish_tpu_torch/csrc/ (one nvcc each, all
             started together); print build seconds and ptxas's register and
             shared-memory lines;
  2. kernel  the CUDA LSAP against the plain PyTorch LSAP on the card and
             scipy.optimize.linear_sum_assignment on the host, >= 200
             matrices at K in {8, 33, 64} (random, tie-heavy, clamped, wide,
             tall, empty, full, and one batched call): 0 mismatches; then
             kernel and plain times at K = 64, B = 1 with CUDA events;
  3. tracker tracker.step at T=64, D=32, G=128, F=128 over a seeded
             countline scene, on the card (kernel) and on the CPU (plain):
             identical ids, states and matched_det on every frame, and the
             crossing counts the scene implies;
  4. slice   FrameStep at 720p with random-init SSD-MobileNetV1 and MARS:
             `step` over 16 frames, `run_chunk` over 8; the LSAP launch
             count is reset before and read after, and must be > 0;
  5. report  the `kernels` JSON line, the card's name and power limit, and
             as the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when there is no card or the port is not
beside this file.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
LSAP_REPLACES = "deepdish_tpu/ops/assignment_pallas.py:49 (_kernel)"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1

def phase_build():
    from deepdish_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("lsap")
    log(f"[build] lsap: built (or loaded) in {time.perf_counter() - t0:.2f} s")
    for line in _build.ptxas_report("lsap").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] lsap: {line.strip()}")


# ---------------------------------------------------------------- phase 2

def _lsap_cases(rng):
    """(K, n_rows, n_cols, (n_rows, n_cols) cost) test matrices."""
    cases = []
    dyadic = np.array([0.125, 0.25, 0.25 + 2.0 ** -12, 0.75], np.float32)
    for K in (8, 33, 64):
        shapes = []
        for _ in range(12):                      # random, any shape
            shapes.append(("random", rng.randint(1, K + 1),
                           rng.randint(1, K + 1)))
        for _ in range(10):
            shapes.append(("ties", rng.randint(1, K + 1),
                           rng.randint(1, K + 1)))
            shapes.append(("clamped", rng.randint(1, K + 1),
                           rng.randint(1, K + 1)))
        for _ in range(5):
            r = rng.randint(2, K + 1)
            shapes.append(("wide", r, rng.randint(1, r)))
            c = rng.randint(2, K + 1)
            shapes.append(("tall", rng.randint(1, c), c))
        shapes += [("empty", 0, rng.randint(1, K + 1)),
                   ("empty", rng.randint(1, K + 1), 0), ("empty", 0, 0),
                   ("full", K, K), ("full", K, K)]
        for kind, r, c in shapes:
            if kind == "ties":
                cost = rng.choice(dyadic, size=(r, c))
            elif kind == "clamped":
                # the tracker's clamp: entries past max_distance become
                # max_distance + 1e-5 (deep_sort linear_assignment.py:57)
                cost = rng.uniform(0.0, 0.4, size=(r, c)).astype(np.float32)
                cost[cost > 0.2] = np.float32(0.2 + 1e-5)
            else:
                cost = rng.uniform(0.0, 1.0, size=(r, c))
            cases.append((K, r, c, cost.astype(np.float32)))
    return cases


def _pad(K, cost):
    out = np.full((K, K), 7e7, np.float32)
    out[:cost.shape[0], :cost.shape[1]] = cost
    return out


def _scipy_assign(K, cost):
    from scipy.optimize import linear_sum_assignment
    want = np.full((K,), -1, np.int32)
    if cost.size:
        rows, cols = linear_sum_assignment(cost.astype(np.float64))
        want[rows] = cols
    return want


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _time_cuda(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(dev):
    import torch
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.ops.assignment import solve_lsap_plain

    rng = np.random.RandomState(SEED)
    cases = _lsap_cases(rng)
    mismatches = 0
    max_abs_err = 0.0           # largest |kernel - plain| column index
    for K, r, c, cost in cases:
        costs = torch.tensor(_pad(K, cost)[None], device=dev)
        sizes = torch.tensor([[r, c]], dtype=torch.int32, device=dev)
        got = lsap.solve(costs, sizes)[0].cpu().numpy()
        plain = solve_lsap_plain(costs, sizes)[0].cpu().numpy()
        want = _scipy_assign(K, cost)
        max_abs_err = max(max_abs_err, float(np.abs(
            got.astype(np.int64) - plain).max()))
        if not (np.array_equal(got, plain) and np.array_equal(got, want)):
            mismatches += 1
            log(f"[kernel] MISMATCH K={K} shape=({r},{c})\n kernel {got}\n"
                f" plain  {plain}\n scipy  {want}")
    # one batched call per K, mixing every shape of that K
    batched = 0
    for K in (8, 33, 64):
        sel = [(r, c, cost) for k, r, c, cost in cases if k == K]
        costs = torch.tensor(np.stack([_pad(K, cost) for _, _, cost in sel]),
                             device=dev)
        sizes = torch.tensor([[r, c] for r, c, _ in sel], dtype=torch.int32,
                             device=dev)
        got = lsap.solve(costs, sizes).cpu().numpy()
        plain = solve_lsap_plain(costs, sizes).cpu().numpy()
        want = np.stack([_scipy_assign(K, cost) for _, _, cost in sel])
        max_abs_err = max(max_abs_err, float(np.abs(
            got.astype(np.int64) - plain).max()))
        bad = int((~((got == plain).all(1) & (got == want).all(1))).sum())
        mismatches += bad
        batched += len(sel)
    torch.cuda.synchronize()
    log(f"[kernel] lsap: {len(cases)} single + {batched} batched matrices, "
        f"{mismatches} mismatches against plain torch and scipy, max "
        f"|kernel - plain| {max_abs_err}")
    if mismatches:
        raise SystemExit("kernel check failed")

    # timing at the tracker's capacity: K = 64, B = 1, a clamped cascade
    # problem of 32 confirmed tracks against 32 detections
    K = 64
    cost = rng.uniform(0.0, 0.4, size=(32, 32)).astype(np.float32)
    cost[cost > 0.2] = np.float32(0.2 + 1e-5)
    costs = torch.tensor(_pad(K, cost)[None], device=dev)
    sizes = torch.tensor([[32, 32]], dtype=torch.int32, device=dev)
    kernel_ms = _time_cuda(lambda: lsap.solve(costs, sizes), 200)
    plain_ms = _time_cuda(lambda: solve_lsap_plain(costs, sizes), 3)
    kernel_ms_2 = _time_cuda(lambda: lsap.solve(costs, sizes), 200)
    # bound: bytes moved once (cost, sizes, out) over HBM; operations: each
    # row's first relaxation covers all 32 columns (3 adds and a compare
    # each), the least work any solve of this input does, over the f32 peak
    nbytes = K * K * 4 + 2 * 4 + K * 4
    ops = 32 * 32 * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    log(f"[kernel] lsap K=64 B=1 (32x32 clamped): kernel {kernel_ms:.5f} / "
        f"{kernel_ms_2:.5f} ms, plain torch {plain_ms:.3f} ms; bound "
        f"{max(bytes_ms, ops_ms):.7f} ms (bytes {bytes_ms:.7f}, ops "
        f"{ops_ms:.7f})")
    return {"name": "lsap", "route": "cuda",
            "source": "deepdish_tpu_torch/csrc/lsap.cu",
            "replaces": LSAP_REPLACES, "mismatches": mismatches,
            "max_abs_err": max_abs_err, "ms": min(kernel_ms, kernel_ms_2),
            "kernel_ms": min(kernel_ms, kernel_ms_2), "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# ---------------------------------------------------------------- phase 3

FRAME_H, FRAME_W = 720, 1280
LINE_X = 640.0


def _walkers(rng, n=24):
    """A countline scene: n objects in separate rows, half walking right
    across x = LINE_X and half walking left, each with a fixed unit
    appearance feature. Every walker crosses after its track confirms."""
    walkers = []
    for k in range(n):
        right = k % 2 == 0
        feat = rng.normal(size=128)
        walkers.append(dict(
            x=rng.uniform(300, 560) if right else rng.uniform(720, 980),
            y=10.0 + 29.0 * k, v=rng.uniform(8, 14) * (1 if right else -1),
            label=(k // 2) % 2, feat=(feat / np.linalg.norm(feat))))
    return walkers


def _scene_frames(rng, walkers, n_frames=60):
    """Per frame: (tlwh, confidence, label, feature) lists, shuffled."""
    frames = []
    for _ in range(n_frames):
        dets = []
        for w in walkers:
            w["x"] += w["v"]
            # 40 px wide: a tentative track (no velocity yet) still
            # overlaps its next box at IoU > 0.3 at the fastest 14 px/frame
            box = [w["x"] + rng.normal(0, 1.0), w["y"] + rng.normal(0, 1.0),
                   40.0, 26.0]
            dets.append((box, float(rng.uniform(0.6, 1.0)), w["label"],
                         w["feat"] + rng.normal(0, 0.05, 128)))
        order = rng.permutation(len(dets))
        frames.append([dets[i] for i in order])
    return frames


def phase_tracker(dev):
    import torch
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.pipeline.counting import CountingState

    rng = np.random.RandomState(SEED + 1)
    walkers = _walkers(rng)
    expected = {"poscount_person": 0, "negcount_person": 0,
                "poscount_car": 0, "negcount_car": 0}
    for w in walkers:
        kind = "poscount_" if w["v"] > 0 else "negcount_"
        expected[kind + ("person", "car")[w["label"]]] += 1
    frames = _scene_frames(rng, walkers)
    cfg = tt.TrackerConfig(max_tracks=64, max_detections=32,
                           gallery_size=128, feature_dim=128, num_labels=2)
    line = np.array([[LINE_X, 0.0], [LINE_X, FRAME_H]])
    records = []
    launches0 = lsap.launches
    t_card = 0.0
    for where in (dev, torch.device("cpu")):
        table = tt.create_table(cfg, where)
        counting = CountingState(["person", "car"], line)
        rec = []
        t0 = time.perf_counter()
        for dets in frames:
            packed = tt.pack_detections(cfg, *zip(*dets), device=where)
            table, out = tt.step(cfg, table, packed)
            counting.process(out)
            rec.append(tuple(x.cpu().numpy() for x in
                             (out.track_id, out.state, out.matched_det)))
        if where == dev:
            _sync(dev)
            t_card = (time.perf_counter() - t0) / len(frames) * 1e3
        records.append((rec, counting.counters_payload()))
    launches = lsap.launches - launches0
    card, cpu = records
    bad = [i for i, (a, b) in enumerate(zip(card[0], cpu[0]))
           if not all(np.array_equal(x, y) for x, y in zip(a, b))]
    counts = {k: card[1][k] for k in expected}
    log(f"[tracker] T=64 D=32 G=128 F=128, {len(frames)} frames, "
        f"{len(walkers)} walkers: {len(bad)} frames differ card vs CPU; "
        f"{launches} LSAP launches on the card, {t_card:.3f} ms/frame "
        f"(host clock, includes packing); counts {counts}, expected "
        f"{expected}")
    if bad:
        raise SystemExit(f"tracker phase: card and CPU differ at frames "
                         f"{bad[:10]}")
    if card[1] != cpu[1] or counts != expected:
        raise SystemExit(f"tracker phase: counts {card[1]} (card), "
                         f"{cpu[1]} (CPU), expected {expected}")
    if launches <= 0:
        raise SystemExit("tracker phase: the LSAP kernel never launched")


# ---------------------------------------------------------------- phase 4

def _framestep(dev, frame_shape, compute_dtype=None):
    import torch
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import (COCO_LABELS, create_box_encoder,
                                           create_detector)
    from deepdish_tpu_torch.pipeline import FrameStep
    # random weights give random classes, so every COCO label is wanted
    # (the CLI default, 'person' alone, would keep ~1/80 of them)
    det = create_detector("ssd_mobilenet", device=dev, max_outputs=32,
                          compute_dtype=compute_dtype,
                          generator=torch.Generator().manual_seed(SEED))
    enc = create_box_encoder("mars", device=dev, compute_dtype=compute_dtype,
                             generator=torch.Generator().manual_seed(SEED + 1))
    cfg = tt.TrackerConfig(max_tracks=64, max_detections=32,
                           gallery_size=128, feature_dim=128,
                           num_labels=len(COCO_LABELS))
    return FrameStep(det, enc, cfg, COCO_LABELS, frame_shape, device=dev)


def _frames(rng, n, shape):
    """One random image plus small per-frame noise: detections persist
    from frame to frame, so tracks confirm and the cascade runs."""
    base = rng.randint(0, 256, shape + (3,))
    noise = rng.randint(-4, 5, (n,) + shape + (3,))
    return np.clip(base[None] + noise, 0, 255).astype(np.uint8)


def _check_outputs(out, snap, T, D):
    import torch
    if tuple(out.track_id.shape[-1:]) != (T,) or \
            tuple(snap.tlwh.shape[-2:]) != (D, 4):
        raise SystemExit(f"slice: unexpected shapes {tuple(out.tlwh.shape)}"
                         f" {tuple(snap.tlwh.shape)}")
    for t in (out.tlwh, snap.tlwh, snap.score):
        if not bool(torch.isfinite(t).all()):
            raise SystemExit("slice: non-finite output")


def phase_slice(dev):
    import torch
    from deepdish_tpu_torch import device as devmod
    from deepdish_tpu_torch.kernels import lsap

    rng = np.random.RandomState(SEED + 2)
    shape = (FRAME_H, FRAME_W)
    fs = _framestep(dev, shape)
    frames = _frames(rng, 16 + 8 + 2, shape)
    warm, seq, chunk = frames[:2], frames[2:18], frames[18:26]

    state = fs.init_state()
    for f in warm:                                   # warm-up, not counted
        state, out, snap, _ = fs.step(state, f)
    fs.run_chunk(fs.init_state(), chunk)
    _sync(dev)

    lsap.launches = 0
    devmod.host_syncs = 0
    dets_per_frame = []
    t0 = time.perf_counter()
    for f in seq:
        state, out, snap, _ = fs.step(state, f)
        dets_per_frame.append(snap.valid.sum())
    _sync(dev)
    step_ms = (time.perf_counter() - t0) / len(seq) * 1e3
    step_syncs = devmod.host_syncs / len(seq)
    step_launches = lsap.launches
    _check_outputs(out, snap, 64, 32)

    devmod.host_syncs = 0
    t0 = time.perf_counter()
    cstate, couts, csnaps = fs.run_chunk(state, chunk)
    _sync(dev)
    chunk_ms = (time.perf_counter() - t0) / len(chunk) * 1e3
    chunk_syncs = devmod.host_syncs / len(chunk)
    launches = lsap.launches
    _check_outputs(couts, csnaps, 64, 32)

    dets = [int(d) for d in dets_per_frame]
    live = int((cstate.table.state != 0).sum())
    confirmed = int((cstate.table.state == 2).sum())
    log(f"[slice] 720p, SSD-MobileNetV1 300x300 + MARS 128x64 in "
        f"{fs.detector.compute_dtype}, tracker T=64 D=32 G=128 F=128")
    log(f"[slice] step: {step_ms:.3f} ms/frame over {len(seq)} frames, "
        f"{step_syncs:.2f} host syncs/frame, detections/frame {dets}")
    log(f"[slice] run_chunk(8): {chunk_ms:.3f} ms/frame, "
        f"{chunk_syncs:.2f} host syncs/frame, detections/frame "
        f"{[int(v) for v in csnaps.valid.sum(1)]}")
    log(f"[slice] LSAP launches: {step_launches} in step, "
        f"{launches - step_launches} in run_chunk; {live} live tracks, "
        f"{confirmed} confirmed at the end")
    if launches <= 0:
        raise SystemExit("slice: the LSAP kernel never launched on the "
                         "main path")
    profile_step(fs, seq[:8], dev)
    if min(dets) <= 0:
        raise SystemExit("slice: a frame had no detections")
    return launches, {"step_ms": step_ms, "chunk_ms": chunk_ms}


STAGES = ("framestep.upload", "framestep.resize", "ssd.net",
          "ssd.decode_nms", "framestep.filter_nms", "framestep.crop_mars",
          "framestep.tracker")


def profile_step(fs, frames, dev):
    """torch.profiler over plain `step` calls: per frame, each stage's
    host time and device time from the record_function ranges FrameStep
    places around its stages, and the device's busy share (CUDA kernel and
    copy time over wall time; the profiler's own cost is in the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = fs.init_state()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            state, _, _, _ = fs.step(state, f)
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(frames)
    host = dict.fromkeys(STAGES, 0.0)
    device = dict.fromkeys(STAGES, 0.0)
    for e in prof.events():
        if e.name in host and e.device_type.name == "CPU":
            host[e.name] += e.cpu_time_total / n / 1e3
            device[e.name] += e.device_time_total / n / 1e3
    log("[slice] stage split of step (torch.profiler ranges, ms/frame "
        "host / device): " + ", ".join(
            f"{k} {host[k]:.3f} / {device[k]:.3f}" for k in STAGES))
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us > 0:
        log(f"[slice] profiler: device busy {busy_us / n:.1f} us/frame of "
            f"{wall_us / n:.1f} us/frame wall (idle share "
            f"{1 - busy_us / wall_us:.3f}); top kernels: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / n:.1f} us"
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[:6]))
    else:
        log("[slice] profiler: no device time recorded (not measured)")


def phase_reference(dev):
    """The slice on a small input in float32 on the card and on the CPU
    (plain versions) with the same weights. Random weights give many
    detections whose scores tie to within an ulp, and the card's and the
    CPU's float32 sums may order such a pair either way, so the check is
    order-free: per frame the same set of (box, label) detections, the same
    set of track ids, and the same set of (state, matched box) tracks. The
    networks' raw outputs must agree to 1e-4 of their range (float32, TF32
    off on both)."""
    import torch
    rng = np.random.RandomState(SEED + 3)
    shape = (96, 128)
    frames = _frames(rng, 6, shape)
    runs, nets = [], []
    for where in (dev, torch.device("cpu")):
        fs = _framestep(where, shape, compute_dtype=torch.float32)
        state = fs.init_state()
        rec = []
        for f in frames:
            state, out, snap, _ = fs.step(state, f)
            rows = torch.cat([snap.tlwh, snap.label[:, None].float()], 1)
            rows = rows[snap.valid].cpu().numpy()
            m = out.matched_det.long()
            box = torch.where((m >= 0)[:, None], snap.tlwh[m.clamp(min=0)],
                              -1.0)
            tracks = torch.cat([out.state[:, None].float(), box], 1)
            tracks = tracks[out.state != 0].cpu().numpy()
            rec.append([rows[np.lexsort(rows.T[::-1])],
                        np.sort(out.track_id.cpu().numpy()),
                        tracks[np.lexsort(tracks.T[::-1])]])
        runs.append(rec)
        image = torch.as_tensor(frames[0], dtype=torch.float32,
                                device=where)
        with torch.inference_mode():
            resized = torch.nn.functional.interpolate(
                image.permute(2, 0, 1)[None], size=(300, 300),
                mode="bilinear").permute(0, 2, 3, 1)
            patches = resized[:, :128, :64]
            nets.append([x.cpu() for x in (*fs.detector.net(resized),
                                           fs.encoder.apply(patches))])
    bad = [i for i, (a, b) in enumerate(zip(*runs))
           if not all(np.array_equal(x, y) for x, y in zip(a, b))]
    n = [len(r[0]) for r in runs[1]]
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(*nets)]
    log(f"[reference] 96x128 float32, 6 frames, detections/frame {n}: "
        f"{len(bad)} frames differ between the card and the CPU; network "
        f"outputs (box, class, MARS) max error / range {errs}")
    if bad:
        raise SystemExit(f"reference check: card and CPU differ at frames "
                         f"{bad}")
    if max(errs) > 1e-4:
        raise SystemExit(f"reference check: network outputs differ {errs}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import deepdish_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the root of the repository", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from deepdish_tpu_torch.device import resolve_device
    resolve_device(dev)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build()
    entry = phase_kernel(dev)
    phase_tracker(dev)
    phase_reference(dev)
    launches, _ = phase_slice(dev)
    entry["launches"] = launches
    log(json.dumps({"kernels": [entry]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
