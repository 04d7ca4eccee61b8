#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (deepdish_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100, sm_90a), nvcc, scipy and cv2 (phase 8 writes
and reads JPEGs). Phases, each fatal on failure:

  1. build   every kernel in deepdish_tpu_torch/csrc/ (lsap, dsconv: one nvcc
             each, all started together); print build seconds;
  2. kernel  ptxas's registers and spills of each instance of lsap.cu's
             warp-per-matrix kernel (Q = 1..8; a spill fails the phase);
             the CUDA LSAP against the plain PyTorch LSAP on the card and
             scipy.optimize.linear_sum_assignment on the host, over
             matrices at K in {1, 8, 32, 33, 64, 65, 128, max_capacity()}
             (random, tie-heavy, clamped, wide, tall, empty, full), each
             alone and in one batched call per K, and two batches of 301
             and 290, more one-warp blocks than SMs: 0 mismatches; then at
             K = 64 (1x1, the 32x32 clamped timed input, 24x24 clamped,
             32x64, 64x64, 16 x 32x32) the device time (CUDA-graph
             replay), the eager round trip (solve + synchronize, host
             clock) and CUDA events over eager calls, beside the Dijkstra
             steps of each input (a numpy replica of scipy's loop, checked
             against scipy) and us a step; the plain version's time;
  3. dsconv  ptxas's registers, spills and serialization warnings and the
             dynamic shared memory of each kernel of dsconv.cu (a spill
             fails the phase); then the CUDA fused depthwise-separable
             kernels against their plain PyTorch version on the card, f32
             and bf16, both strides: the JAX kernel test's shapes, 75x75
             odd, the bf16 kernel's paths (ds13 and ds7 at batch 1, whose
             launch plans split K; Cin = Cout = 8, zero-padded K and N;
             Cin = 40; Cin = 12, scalar taps; M not a multiple of the tile),
             the nine probe STAGES at batch 2 (and at batch 32 in bf16, the
             probe's own inputs), and the SSD's 13 ds blocks at batch 1 with
             weights folded from a random-init port SSDMobileNetV1 (also
             held against each module's f32 forward); f32 within atol 2e-5 +
             rtol 1e-5, bf16 within ops.dsconv.reorder_tolerance (the bound
             on reordering the f32 pointwise sum), the intermediate
             bit-equal; then kernel, plain, cuDNN 2-conv and bound, with the
             launch plan, per stage at batch 32 and per SSD block at batch 1;
  4. tracker tracker.step at T=64, D=32, G=128, F=128 over a seeded
             countline scene, on the card (kernel) and on the CPU (plain):
             identical ids, states and matched_det on every frame, and the
             crossing counts the scene implies;
  5. slice   FrameStep at 720p with random-init SSD-MobileNetV1 and MARS:
             `step` over 16 frames, `run_chunk` over 8; the LSAP launch
             count is reset before and read after, and must be > 0;
  6. cli     the port's CLI and what it adds under the frame step, at 720p
             on a seeded walker scene (bright blocks on a dark background,
             crossing x = 640): MOG2 on the card against the CPU (mask
             agreement >= 0.999, identical motion decisions); FrameStep
             `step` with bgsub on (ms/frame, host syncs, the profiler's
             stage split with framestep.bgsub); `run_chunk_yuv` against
             `run_chunk` (identical outputs, ms/frame); then
             `deepdish_tpu_torch.pipeline.main.amain` with the scene given
             through `Pipeline._open_capture`, --disable-graphics
             --streaming 0 --control-port 0 and a --log in a temporary
             directory: the default configuration (ssd_mobilenet + MARS,
             bgsub on, every COCO label wanted) at --chunk-size 1 and 8,
             every frame finite, its objd and e2e ms/frame; the same in
             float32 on the card and on the CPU at chunk 1 and 8, whose
             counters must agree at each chunk size; and
             `--model scripted:bright` on the card (LSAP launches, reset
             before and read after, > 0) and on the CPU, whose counters
             must both equal the crossings the scene implies;
  7. families YOLOv5s (320), YOLOv3 (416) and EfficientDet-Lite0 (320) at
             full width, seeded random weights with calibrated batch norms
             (`_family_init`; FAMILY_THRESHOLD): float32 detector outputs
             on the card against the CPU port on two resized (YOLOv3:
             letterboxed) 720p frames (integers exact, order-free only
             among scores tied to 1e-5); FrameStep `step` over 16 frames
             and `run_chunk` over 8 in bf16 (ms/frame, host syncs/frame,
             LSAP launches > 0); the CLI at --chunk-size 8 (every frame
             finite, objd and e2e);
  8. cvat    CVAT split mode through the CLI: the walker scene as a JPEG
             sequence with one annotated track, --input-cvat-dir and
             --output-cvat-dir; float32 with FrameStep.detect_only replaced
             by the bright-block script on the card and on the CPU (the
             two annotations.xml byte-identical, LSAP launches > 0), then
             the random SSD in bf16 on the card (LSAP launches > 0);
  9. frcnn   Faster R-CNN at full width (FasterRCNNConfig(): ResNet-101
             C4 at 640, 90 classes, pre_nms_topk 1024, 300 proposals),
             seeded weights with batch norms calibrated on the walker scene
             (`_frcnn_donor`): float32 on the card against the CPU port on
             two resized 720p frames, stage by stage (`_frcnn_card_vs_cpu`:
             trunk and RPN heads within 1e-3 of their range, the proposal
             selection on the card's heads with equal valid slots, both
             second-stage modes on the card's fmap and proposals by
             `_compare_detections`); the TF-free name-map conversion
             (TF-OD resnet_v1_101 names -> convert_faster_rcnn_tfod: config
             (3, 4, 23, 3), card detections identical to the donor's);
             FrameStep `step` over 16 frames and `run_chunk` over 8 in bf16
             (ms/frame, host syncs/frame, LSAP launches > 0, the profiler's
             stage split and idle share); the CLI on the weights as a .npz
             with a .pbtxt label map at --chunk-size 8 (every frame finite,
             objd and e2e);
 10. tflite  the structural weight path on artifacts the script writes
             itself with numpy (`write_tflite`; there is no tensorflow on
             the card's machine): a full-width SSD-MobileNetV1 (300, 91
             classes) whose box and class heads come in reverse level
             order and which ends in a TFLite_Detection_PostProcess op
             (generated anchors, scales 10/10/5/5, max_detections 10 <
             max_outputs 32), and a MARS encoder, each from a seeded donor
             with batch norms calibrated on the walker scene; both
             converted by the port (report complete, anchors verified,
             conversion seconds); float32 on the card, the converted SSD's
             detections against the donor's with the op's configuration
             (`_compare_detections`, scores and boxes within 1e-4 of their
             range) and MARS features within 1e-4; then the CLI with
             --model and --encoder-model on the two files at --chunk-size 8
             in bf16 (every frame finite, LSAP launches > 0, objd and e2e);
 11. probe   the ported dsconv probe (deepdish_tpu_torch.tools.probe_dsconv)
             at full width: batch 32, 6 layers, all 9 stages, 2 rounds of 4;
             the dsconv launch counts are reset before and read after, and
             both strides must have launched;
 12. report  the `kernels` JSON line (the LSAP's launches: phases 5, 7, 8,
             9 and 10), the card's name and power limit, and as the last
             line {"ok": true, "device": {...}}.

Each phase prints its seconds.
Exits non-zero, printing no result, when there is no card or the port is not
beside this file.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
KERNELS = ("lsap", "dsconv")     # csrc/<name>.cu
LSAP_REPLACES = "deepdish_tpu/ops/assignment_pallas.py:49 (_kernel)"
DSCONV_SOURCE = "deepdish_tpu_torch/csrc/dsconv.cu"
DSCONV_REPLACES = {
    1: "deepdish_tpu/ops/dsconv_pallas.py:83 (_dsconv_s1_kernel)",
    2: "deepdish_tpu/ops/dsconv_pallas.py:110 (_dsconv_s2_kernel)"}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1

def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from deepdish_tpu_torch.kernels import _build

    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        secs = dict(zip(KERNELS, pool.map(build, KERNELS)))
    log(f"[build] {len(KERNELS)} kernels, one nvcc each in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        log(f"[build] {name}: built (or loaded) in {secs[name]:.2f} s")


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


def _lsap_more_cases(rng, ks):
    """Cases at the K values past the tracker's: fewer above K = 64, where
    the plain solver on the card is slow; every orientation, ties, the
    tracker's clamp, full and empty."""
    dyadic = np.array([0.125, 0.25, 0.25 + 2.0 ** -12, 0.75], np.float32)
    cases = []
    for K in ks:
        n = 2 if K > 64 else 4

        def any_shape():
            return rng.randint(1, K + 1), rng.randint(1, K + 1)
        shapes = [(kind,) + any_shape() for kind in ("random", "ties",
                                                     "clamped")
                  for _ in range(n)]
        shapes += [("clamped", K, K), ("random", K, K), ("ties", K, K),
                   ("empty", 0, K), ("empty", K, 0), ("empty", 0, 0)]
        if K > 1:
            r, c = rng.randint(2, K + 1), rng.randint(2, K + 1)
            shapes += [("clamped", r, rng.randint(1, r)),
                       ("random", rng.randint(1, c), c)]
        for kind, r, c in shapes:
            cases.append((K, r, c, _lsap_cost(rng, kind, r, c, dyadic)))
    return cases


def _lsap_cost(rng, kind, r, c, dyadic=None):
    if kind == "ties":
        return rng.choice(dyadic, size=(r, c)).astype(np.float32)
    if kind == "clamped":
        cost = rng.uniform(0.0, 0.4, size=(r, c)).astype(np.float32)
        cost[cost > 0.2] = np.float32(0.2 + 1e-5)
        return cost
    return rng.uniform(0.0, 1.0, size=(r, c)).astype(np.float32)


def _sap_steps(cost):
    """scipy's shortest augmenting path (rectangular_lsap.cpp), replicated
    in numpy on the float64 cost: (row -> col assignment, Dijkstra steps).
    The steps are what a solve of this input walks through serially."""
    cost = np.asarray(cost, np.float64)
    transposed = cost.shape[0] > cost.shape[1]
    if transposed:
        cost = cost.T
    nr, nc = cost.shape
    u, v = np.zeros(nr), np.zeros(nc)
    col4row = np.full(nr, -1)
    row4col = np.full(nc, -1)
    steps = 0
    for cur_row in range(nr):
        spc = np.full(nc, np.inf)
        path = np.full(nc, -1)
        sr = np.zeros(nr, bool)
        sc = np.zeros(nc, bool)
        remaining = np.arange(nc)[::-1].copy()
        num_rem, i, min_val, sink = nc, cur_row, 0.0, -1
        while sink < 0:
            steps += 1
            sr[i] = True
            rem = remaining[:num_rem]
            r = min_val + cost[i, rem] - u[i] - v[rem]
            better = r < spc[rem]
            path[rem[better]] = i
            spc[rem[better]] = r[better]
            vals = spc[rem]
            tied = np.flatnonzero(vals == vals.min())
            unm = tied[row4col[rem[tied]] < 0]
            index = unm[-1] if unm.size else tied[0]
            min_val = vals[index]
            j = remaining[index]
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
            sc[j] = True
            remaining[index] = remaining[num_rem - 1]
            num_rem -= 1
        u[cur_row] += min_val
        rows = np.flatnonzero(sr & (np.arange(nr) != cur_row))
        u[rows] += min_val - spc[col4row[rows]]
        v[sc] -= min_val - spc[sc]
        j = sink
        while True:
            i = path[j]
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur_row:
                break
    if transposed:                       # rows of the solve are columns
        return {int(c): i for i, c in enumerate(col4row)}, steps
    return {i: int(c) for i, c in enumerate(col4row)}, steps


def _round_trip_ms(fn, reps):
    """What a caller that reads the answer waits for: host clock over
    `fn` + torch.cuda.synchronize(), after warm-up (ms a call)."""
    import torch
    for _ in range(10):
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _lsap_build_report():
    """ptxas's lines of each instance of the LSAP kernel (Q = 1..8); a
    spill fails the phase."""
    spills = _ptxas_kernels("lsap", "lsap_kernel", "kernel")
    if spills:
        raise SystemExit(f"lsap: ptxas spills registers in {spills}")


def _check_lsap(dev, K, sel, singles):
    """The (r, c, cost) matrices of one K in one batched kernel call and,
    with `singles`, one call each, against one batched call of the plain
    solver on the card and against scipy. Returns (mismatches, largest
    |kernel - plain| column index)."""
    import torch
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.ops.assignment import solve_lsap_plain
    costs = torch.tensor(np.stack([_pad(K, cost) for _, _, cost in sel]),
                         device=dev)
    sizes = torch.tensor([[r, c] for r, c, _ in sel], dtype=torch.int32,
                         device=dev)
    plain = solve_lsap_plain(costs, sizes).cpu().numpy()
    want = np.stack([_scipy_assign(K, cost) for _, _, cost in sel])
    runs = [lsap.solve(costs, sizes).cpu().numpy()]
    if singles:
        runs.append(np.stack([lsap.solve(costs[n:n + 1], sizes[n:n + 1])[0]
                              .cpu().numpy() for n in range(len(sel))]))
    bad, err = np.zeros(len(sel), bool), 0.0
    for got in runs:
        err = max(err, float(np.abs(got.astype(np.int64) - plain).max()))
        bad |= ~((got == plain).all(1) & (got == want).all(1))
    for n in np.flatnonzero(bad)[:5]:
        r, c, _ = sel[n]
        log(f"[kernel] MISMATCH K={K} shape=({r},{c})\n "
            + "\n ".join(f"kernel {g[n]}" for g in runs)
            + f"\n plain  {plain[n]}\n scipy  {want[n]}")
    return int(bad.sum()), err


def phase_kernel(dev):
    import torch
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.ops.assignment import solve_lsap_plain

    _lsap_build_report()
    cap = lsap.max_capacity()
    if cap < 236:
        raise SystemExit(f"lsap: capacity {cap} below the 236 of the "
                         "block-per-matrix design")
    rng = np.random.RandomState(SEED)
    cases = _lsap_cases(rng)
    # the timed input, drawn right after the cases as it always was, so
    # that its times compare across versions of the kernel
    timed_32 = rng.uniform(0.0, 0.4, size=(32, 32)).astype(np.float32)
    timed_32[timed_32 > 0.2] = np.float32(0.2 + 1e-5)
    more = np.random.RandomState(SEED + 7)
    cases += _lsap_more_cases(more, (1, 32, 65, 128, cap))
    mismatches, max_abs_err, counted = 0, 0.0, {}
    for K in sorted({k for k, _, _, _ in cases}):
        sel = [(r, c, cost) for k, r, c, cost in cases if k == K]
        bad, err = _check_lsap(dev, K, sel, singles=True)
        mismatches += bad
        max_abs_err = max(max_abs_err, err)
        counted[K] = len(sel)
    # batches of more one-warp blocks than the card has SMs
    batches = []
    for K, B in ((8, 301), (64, 290)):
        sel = []
        for n in range(B):
            r, c = more.randint(0, K + 1), more.randint(0, K + 1)
            sel.append((r, c, _lsap_cost(more, ("random", "clamped")[n % 2],
                                         r, c)))
        bad, err = _check_lsap(dev, K, sel, singles=False)
        mismatches += bad
        max_abs_err = max(max_abs_err, err)
        batches.append(f"B={B} K={K} ({lsap.plan(B, K).grid} blocks)")
    torch.cuda.synchronize()
    log(f"[kernel] lsap: capacity {cap}; matrices by K {counted}, each "
        f"alone and in one batched call, and batched " + ", ".join(batches)
        + f": {mismatches} mismatches against plain torch and scipy, max "
        f"|kernel - plain| {max_abs_err}")
    if mismatches:
        raise SystemExit("kernel check failed")

    # timing at the tracker's capacity K = 64: the fixed cost (1x1), the
    # cascade's 32 tracks x 32 detections (the timed input of every PR),
    # phase 4's 24 walkers, a tall and a full problem, and a batch
    K = 64
    clamp = np.random.RandomState(SEED + 8)
    timed = [("1x1", [_lsap_cost(clamp, "random", 1, 1)]),
             ("32x32 clamped", [timed_32]),
             ("24x24 clamped", [_lsap_cost(clamp, "clamped", 24, 24)]),
             ("32x64 random", [_lsap_cost(clamp, "random", 32, 64)]),
             ("64x64 random", [_lsap_cost(clamp, "random", 64, 64)]),
             ("16 x 32x32 clamped", [_lsap_cost(clamp, "clamped", 32, 32)
                                     for _ in range(16)])]
    log("[kernel] lsap K=64, ms a call: device (CUDA-graph replay of 50 "
        "calls) | eager round trip (host clock over solve + synchronize, "
        "200 calls) | CUDA events over 200 eager calls (the first kernel's measure); "
        "Dijkstra steps (numpy replica of scipy's loop; a batch: the most "
        "of one matrix / the sum), us a step of the device time")
    times = {}
    for name, mats in timed:
        steps = []
        for cost in mats:
            assign, n = _sap_steps(cost)
            want = _scipy_assign(K, cost)
            if any(want[r] != c for r, c in assign.items()) or \
                    sum(want >= 0) != len(assign):
                raise SystemExit(f"lsap: the step-count replica disagrees "
                                 f"with scipy on {name}")
            steps.append(n)
        costs = torch.tensor(np.stack([_pad(K, c) for c in mats]),
                             device=dev)
        sizes = torch.tensor([c.shape for c in mats], dtype=torch.int32,
                             device=dev)

        def call():
            return lsap.solve(costs, sizes)
        t = (_graph_ms(call, 50), _round_trip_ms(call, 200),
             _time_cuda(call, 200))
        times[name] = t
        log(f"[kernel]   {name:18s}: {t[0]:.5f} | {t[1]:.5f} | {t[2]:.5f}; "
            f"steps {max(steps)} / {sum(steps)}, "
            f"{t[0] * 1e3 / max(steps):.4f} us a step")
        if name == "32x32 clamped":
            plain_ms = _time_cuda(lambda: solve_lsap_plain(costs, sizes), 3)
    kernel_ms, eager_ms, events_ms = times["32x32 clamped"]
    # bound: bytes the function must move once over HBM: the live block of
    # the cost (all a solve reads of the padded matrix), the sizes and the
    # (K,) output; operations: each row's first relaxation covers all its
    # columns (3 adds and a compare each), the least work any solve of this
    # input does, over the f32 peak
    rows, cols = timed_32.shape
    nbytes = rows * cols * 4 + 2 * 4 + K * 4
    ops = rows * cols * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    log(f"[kernel] lsap K=64 B=1 (32x32 clamped): kernel {kernel_ms:.5f} ms "
        f"device, {eager_ms:.5f} ms eager round trip, plain torch "
        f"{plain_ms:.3f} ms; bound {max(bytes_ms, ops_ms):.7f} ms (bytes "
        f"{bytes_ms:.7f}, ops {ops_ms:.7f})")
    return {"name": "lsap", "route": "cuda",
            "source": "deepdish_tpu_torch/csrc/lsap.cu",
            "replaces": LSAP_REPLACES, "mismatches": mismatches,
            "max_abs_err": max_abs_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "eager_round_trip_ms": eager_ms,
            "events_ms": events_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# ---------------------------------------------------------------- phase 3

# the JAX kernel test's shapes (tests/test_dsconv_pallas.py) and 75x75 odd:
# (batch, H, W, Cin, Cout, stride)
DSCONV_SHAPES = [(2, 10, 12, 8, 16, 1), (2, 11, 13, 8, 16, 2),
                 (2, 10, 12, 8, 16, 2), (2, 9, 9, 16, 8, 1),
                 (1, 75, 75, 16, 32, 1), (1, 75, 75, 16, 32, 2),
                 # the bf16 kernel's paths: K split at batch 1 (ds13, ds7),
                 # K and N padded, a 5-chunk slice, scalar taps, ragged M
                 (1, 10, 10, 1024, 1024, 1), (1, 19, 19, 512, 512, 1),
                 (1, 9, 9, 8, 8, 1), (2, 19, 19, 40, 72, 2),
                 (3, 7, 7, 12, 24, 1)]
# the two timed shapes: the compute-bound and the bytes-bound extreme
DSCONV_TIMED = {1: "ds13", 2: "ds2"}


def _test_inputs(rng, b, h, w, cin, cout, dev, dtype):
    """The JAX kernel test's distributions (tests/test_dsconv_pallas.py)."""
    import torch

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    return (f32(rng.standard_normal((b, h, w, cin))).to(dtype),
            f32(rng.standard_normal((3, 3, cin)) * 0.2),
            f32(rng.random(cin) + 0.5), f32(rng.standard_normal(cin) * 0.1),
            f32(rng.standard_normal((cin, cout)) * 0.2),
            f32(rng.random(cout) + 0.5), f32(rng.standard_normal(cout) * 0.1))


def _probe_inputs(rng, b, h, w, cin, cout, dev):
    """The probe's own distributions, bf16 (tools/probe_dsconv.py)."""
    import torch
    from deepdish_tpu_torch.tools.probe_dsconv import block_weights
    x = torch.as_tensor(rng.standard_normal((b, h, w, cin)) * 0.1).to(
        dev, torch.bfloat16)
    return (x,) + block_weights(rng, cin, cout, dev)


def _bf16_key(t):
    """Monotone integer key of bf16 values: neighbours differ by one (one
    ulp); -0 and +0 share a key."""
    import torch
    bits = t.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _new_tally():
    return {s: {"cases": 0, "mismatches": 0, "max_abs_err": 0.0,
                "max_abs_err_f32": 0.0, "max_ulp_bf16": 0, "n_diff": 0,
                "n_over_1ulp": 0, "n_out": 0}
            for s in (1, 2)}


def _check_dsconv(tally, what, args, stride):
    """Kernel against plain on the card. f32: atol 2e-5 + rtol 1e-5 (the JAX
    kernel test's). bf16: within ops.dsconv.reorder_tolerance (the bound on
    reordering the f32 pointwise sum, the only difference, plus one ulp of
    the final rounding). Both: the intermediate bit-equal, read as the output
    of an identity pointwise kernel with unit scale and zero bias."""
    import torch
    from deepdish_tpu_torch.kernels import dsconv
    from deepdish_tpu_torch.ops.dsconv import dsconv_plain, reorder_tolerance
    x = args[0]
    got = dsconv.fused(*args, stride=stride)
    want = dsconv_plain(*args, stride=stride)
    cin = x.shape[-1]
    ones = torch.ones(cin, device=x.device)
    ident = tuple(args[:4]) + (torch.eye(cin, device=x.device), ones,
                               torch.zeros_like(ones))
    mid_equal = torch.equal(dsconv.fused(*ident, stride=stride),
                            dsconv_plain(*ident, stride=stride))
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    t = tally[stride]
    err = float(diff.max())
    t["cases"] += 1
    t["max_abs_err"] = max(t["max_abs_err"], err)
    t["n_diff"] += int((g != w).sum())
    t["n_out"] += g.numel()
    ok = (got.shape == want.shape and got.dtype == x.dtype and mid_equal
          and bool(torch.isfinite(g).all()))
    if x.dtype == torch.float32:
        t["max_abs_err_f32"] = max(t["max_abs_err_f32"], err)
        ok = ok and bool((diff <= 2e-5 + 1e-5 * w.abs()).all())
        ulp = None
    else:
        ulps = (_bf16_key(got) - _bf16_key(want)).abs()
        ulp = int(ulps.max())
        t["max_ulp_bf16"] = max(t["max_ulp_bf16"], ulp)
        t["n_over_1ulp"] += int((ulps > 1).sum())
        ok = ok and bool((diff <= reorder_tolerance(got, want, *args,
                                                    stride=stride)).all())
    if not ok:
        t["mismatches"] += 1
        log(f"[dsconv] MISMATCH {what} s{stride} {str(x.dtype)[6:]}: max "
            f"|kernel - plain| {err}, ulps {ulp}, intermediate bit-equal "
            f"{mid_equal}, shapes "
            f"{tuple(got.shape)} {tuple(want.shape)}")


def _dsconv_bound(b, h, w, cin, cout, stride, elem=2):
    """(bound_ms, bound_by): bytes = input + output + weights once each at
    the HBM rate; operations = the pointwise product at the dense bf16
    tensor-core rate plus the depthwise sum at the f32 rate."""
    ho, wo = -(-h // stride), -(-w // stride)
    m = b * ho * wo
    nbytes = (elem * (b * h * w * cin + m * cout + 9 * cin + cin * cout)
              + 4 * 2 * (cin + cout))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * m * cin * cout / BF16_OPS_PER_S
              + 2 * 9 * m * cin / F32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _plan_str(b, h, w, cin, cout, stride):
    from deepdish_tpu_torch.kernels import dsconv
    p = dsconv.plan(b, h, w, cin, cout, stride)
    return (f"[{dsconv.BLOCK_M}x{p.block_n}, K {p.k_splits}x{p.k_chunk}, "
            f"{p.grid} blocks]")


def _ptxas_kernels(lib, kinds, tag):
    """Log ptxas's register and spill lines of each kernel in
    csrc/<lib>.cu whose name matches `kinds` (template arguments
    spelled out); returns the kernels that spill."""
    import re

    from deepdish_tpu_torch.kernels import _build
    name, spills = None, []
    for line in _build.ptxas_report(lib).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:   # e.g. dsconv_bf16_kernel<256, 2>: block_n, stride
            kind = re.search(rf"({kinds})(?:I((?:Li\d+E)+)E)?",
                             entry.group(1))
            args = re.findall(r"Li(\d+)E", kind.group(2) or "")
            name = kind.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif name and ("registers" in line or "spill" in line):
            log(f"[{tag}] ptxas {name}: {line.split(':', 1)[-1].strip()}")
            if re.search(r"[1-9]\d* bytes spill", line):
                spills.append(name)
    return spills


def _dsconv_build_report():
    """ptxas's lines of each kernel of dsconv.cu, the bf16 blocks' dynamic
    shared memory, and the count of wgmma serialization warnings (C7515);
    a kernel that spills fails the phase."""
    from deepdish_tpu_torch.kernels import _build, dsconv
    spills = _ptxas_kernels(
        "dsconv", "dsconv_(?:bf16_kernel|f32_kernel|splitk_epilogue)",
        "dsconv")
    lines = _build.ptxas_report("dsconv").splitlines()
    log("[dsconv] bf16 dynamic shared memory per block: " + ", ".join(
        f"{bn} wide {dsconv.smem_bytes(bn)} B" for bn in (64, 128, 256)) +
        f"; wgmma serialization warnings (C7515): "
        f"{sum('C7515' in line for line in lines)}")
    if spills:
        raise SystemExit(f"dsconv: ptxas spills registers in {spills}")


def _graph_ms(fn, reps):
    """Time of one call (ms) with the host taken out: `reps` calls captured
    in one CUDA graph, the graph replayed under CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _time_cuda(graph.replay, 5) / reps


def _ssd_blocks(dev, tally):
    """The SSD's 13 ds blocks at batch 1 on their real activations: a
    random-init port SSDMobileNetV1 (flax-default convs, random batch-norm
    statistics so the fold is no identity) driven from a random 300x300
    image. Per block: kernel vs plain (f32, bf16), the f32 kernel vs the
    module's own f32 forward within 1e-5 of its output's range, and bf16
    times of the kernel, the cuDNN 2-conv and the module's bf16 forward
    (the SSD's current path)."""
    import copy

    import torch
    from deepdish_tpu_torch.kernels import dsconv
    from deepdish_tpu_torch.models.layers import BatchNorm, flax_default_init_
    from deepdish_tpu_torch.models.ssd_mobilenet import SSDMobileNetV1
    from deepdish_tpu_torch.ops.dsconv import dsconv_reference

    net = SSDMobileNetV1()
    flax_default_init_(net, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    net = net.to(dev).eval()
    rng = np.random.RandomState(SEED + 6)
    image = torch.tensor(rng.randint(0, 256, (1, 300, 300, 3)),
                         dtype=torch.float32, device=dev)
    rows, worst = [], 0.0
    with torch.inference_mode():
        x = net.conv0(((image * (2.0 / 255.0)) - 1.0).permute(0, 3, 1, 2))
        for k in range(1, 14):
            mod = getattr(net, f"ds{k}")
            stride = mod.dw.stride[0]
            ws = mod.fused_args()
            xin = x.permute(0, 2, 3, 1).contiguous()
            want = mod(x).permute(0, 2, 3, 1)
            got = dsconv.fused(xin, *ws, stride=stride)
            span = float(want.max() - want.min())
            rel = float((got - want).abs().max()) / max(span, 1e-30)
            worst = max(worst, rel)
            if not rel <= 1e-5:
                raise SystemExit(f"dsconv: ds{k} kernel differs from the "
                                 f"module's f32 forward by {rel} of the "
                                 f"output's range {span}")
            _check_dsconv(tally, f"ssd ds{k}", (xin,) + ws, stride)
            x16 = xin.bfloat16()
            _check_dsconv(tally, f"ssd ds{k}", (x16,) + ws, stride)
            mod16 = copy.deepcopy(mod).to(torch.bfloat16)
            x16n = x16.permute(0, 3, 1, 2)         # the SSD's NCHW view
            b, h, w, cin = xin.shape
            cout = ws[3].shape[1]
            legs = (lambda: dsconv.fused(x16, *ws, stride),
                    lambda: dsconv_reference(x16, *ws, stride),
                    lambda: mod16(x16n))
            rows.append((f"ds{k}", h, cin, cout, stride,
                         _plan_str(1, h, w, cin, cout, stride),
                         [_time_cuda(f, 100) for f in legs],
                         [_graph_ms(f, 20) for f in legs],
                         _dsconv_bound(1, h, w, cin, cout, stride)[0], span))
            x = want.permute(0, 3, 1, 2)
    log(f"[dsconv] SSD ds1-ds13 at batch 1 (real activations, folded "
        f"random weights): f32 kernel vs module forward, largest error "
        f"{worst:.3e} of the output's range")
    log("[dsconv] batch 1 bf16, ms per block, kernel / cudnn 2-conv / SSD "
        "module: CUDA events over 100 eager calls (host launch gaps "
        "included) | CUDA-graph replay of 20 calls (host taken out) | bound "
        "(output range)")
    tot = np.zeros(6)
    for name, h, cin, cout, s, plan, event, device, b_ms, span in rows:
        tot += event + device
        log(f"[dsconv]   {name:5s} {h:3d}^2 {cin:4d}->{cout:4d} s{s}: "
            + " / ".join(f"{t:.5f}" for t in event) + " | "
            + " / ".join(f"{t:.5f}" for t in device) + f" | {b_ms:.5f} "
            f"({span:.3f}) {plan}")
    log("[dsconv]   sum of 13: " + " / ".join(f"{t:.5f}" for t in tot[:3])
        + " | " + " / ".join(f"{t:.5f}" for t in tot[3:]))


def phase_dsconv(dev):
    """Kernel vs plain at every listed shape, then the timing tables;
    returns the two `kernels` entries (launches filled in by the probe)."""
    import torch
    from deepdish_tpu_torch.kernels import dsconv
    from deepdish_tpu_torch.ops.dsconv import dsconv_plain, dsconv_reference
    from deepdish_tpu_torch.tools.probe_dsconv import STAGES

    _dsconv_build_report()
    rng = np.random.default_rng(SEED + 4)
    tally = _new_tally()
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, cin, cout, s in DSCONV_SHAPES:
            _check_dsconv(tally, f"test {b}x{h}x{w} {cin}->{cout}",
                          _test_inputs(rng, b, h, w, cin, cout, dev, dtype),
                          s)
        for label, h, w, cin, cout, s in STAGES:
            _check_dsconv(tally, f"{label} batch 2",
                          _test_inputs(rng, 2, h, w, cin, cout, dev, dtype),
                          s)
    for label, h, w, cin, cout, s in STAGES:
        _check_dsconv(tally, f"{label} batch 32",
                      _probe_inputs(rng, 32, h, w, cin, cout, dev), s)
    _ssd_blocks(dev, tally)
    for s in (1, 2):
        t = tally[s]
        log(f"[dsconv] stride {s}: {t['cases']} cases, {t['mismatches']} "
            f"mismatches; {t['n_diff']} of {t['n_out']} outputs differ from "
            f"plain; max |kernel - plain| f32 {t['max_abs_err_f32']:.3e}; "
            f"bf16 {t['max_abs_err']:.3e}, {t['n_over_1ulp']} outputs over "
            f"one ulp (largest {t['max_ulp_bf16']} ulp), all within the "
            f"reorder tolerance")
    if any(tally[s]["mismatches"] for s in (1, 2)):
        raise SystemExit("dsconv kernel check failed")

    log("[dsconv] batch 32 bf16, ms per block: stage: kernel / cudnn "
        "2-conv (CUDA events over 20 eager calls) | kernel / cudnn 2-conv "
        "(CUDA-graph replay of 20 calls: device time) | bound (bound by) "
        "[launch plan] {kernel at block_n 64 / 128 / 256 with K whole, "
        "eager: the plan's choice of width}")
    entries = {}
    for label, h, w, cin, cout, s in STAGES:
        args = _probe_inputs(rng, 32, h, w, cin, cout, dev)
        kernel_ms = _time_cuda(lambda: dsconv.fused(*args, s), 20)
        library_ms = _time_cuda(lambda: dsconv_reference(*args, s), 20)
        bound_ms, bound_by = _dsconv_bound(32, h, w, cin, cout, s)
        m = 32 * -(-h // s) * -(-w // s)
        widths = [_time_cuda(lambda: dsconv.fused(
            *args, s, launch_plan=dsconv.Plan(m, cout, cin, bn, 16 * -(
                -cin // 16))), 20) for bn in (64, 128, 256)]
        graphs = [_graph_ms(lambda: dsconv.fused(*args, s), 20),
                  _graph_ms(lambda: dsconv_reference(*args, s), 20)]
        log(f"[dsconv]   {label}: {kernel_ms:.5f} / {library_ms:.5f} | "
            f"{graphs[0]:.5f} / {graphs[1]:.5f} | {bound_ms:.5f} "
            f"({bound_by}) {_plan_str(32, h, w, cin, cout, s)} {{"
            + " / ".join(f"{t:.5f}" for t in widths) + "}")
        if label.startswith(DSCONV_TIMED[s]):
            plain_ms = _time_cuda(lambda: dsconv_plain(*args, s), 5)
            t = tally[s]
            entries[s] = {
                "name": f"dsconv_s{s}", "route": "cuda",
                "source": DSCONV_SOURCE, "replaces": DSCONV_REPLACES[s],
                "shape": f"{label.split()[0]} x (32, {h}, {w}, {cin}) bf16 "
                         f"-> {cout}",
                "mismatches": t["mismatches"],
                "max_abs_err": t["max_abs_err"],
                "max_abs_err_f32": t["max_abs_err_f32"],
                "max_ulp_bf16": t["max_ulp_bf16"],
                # kernel and cuDNN both by CUDA-graph replay (device
                # time), the CUDA-event times over eager calls beside them
                "ms": graphs[0], "events_ms": kernel_ms,
                "plain_ms": plain_ms, "library_ms": graphs[1],
                "library_events_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"[dsconv]   {label}: kernel {graphs[0]:.5f} ms, cuDNN "
                f"{graphs[1]:.5f} ms (graph replay), plain torch "
                f"{plain_ms:.5f} ms (the timed entry of stride {s})")
        del args
    return [entries[1], entries[2]]


# ---------------------------------------------------------------- phase 4

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


# ---------------------------------------------------------------- phase 5

def _framestep(dev, frame_shape, compute_dtype=None, step_cfg=None,
               detector=None):
    """A FrameStep at the CLI's default widths with random seeded weights:
    `detector`, or SSD-MobileNetV1, and MARS."""
    import torch
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import (COCO_LABELS, create_box_encoder,
                                           create_detector)
    from deepdish_tpu_torch.pipeline import FrameStep, FrameStepConfig
    # random weights give random classes, so every COCO label is wanted
    # (the CLI default, 'person' alone, would keep ~1/80 of them)
    det = detector or create_detector(
        "ssd_mobilenet", device=dev, max_outputs=32,
        compute_dtype=compute_dtype,
        generator=torch.Generator().manual_seed(SEED))
    enc = create_box_encoder("mars", device=dev, compute_dtype=compute_dtype,
                             generator=torch.Generator().manual_seed(SEED + 1))
    cfg = tt.TrackerConfig(max_tracks=64, max_detections=32,
                           gallery_size=128, feature_dim=128,
                           num_labels=len(COCO_LABELS))
    return FrameStep(det, enc, cfg, COCO_LABELS, frame_shape,
                     step_cfg or FrameStepConfig(), device=dev)


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


STAGES = ("framestep.upload", "framestep.bgsub", "framestep.resize",
          "ssd.net",
          "ssd.decode_nms", "framestep.filter_nms", "framestep.crop_mars",
          "framestep.tracker")


def profile_step(fs, frames, dev, tag="slice", state=None, stages=STAGES):
    """torch.profiler over plain `step` calls: per frame, each stage's
    host time and device time from the record_function ranges FrameStep
    places around its stages, and the device's busy share (CUDA kernel and
    copy time over wall time; the profiler's own cost is in the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if state is None:
        state = fs.init_state()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            state, _, _, _ = fs.step(state, f)
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(frames)
    host = dict.fromkeys(stages, 0.0)
    device = dict.fromkeys(stages, 0.0)
    for e in prof.events():
        if e.name in host and e.device_type.name == "CPU":
            host[e.name] += e.cpu_time_total / n / 1e3
            device[e.name] += e.device_time_total / n / 1e3
    log(f"[{tag}] stage split of step (torch.profiler ranges, ms/frame "
        "host / device): " + ", ".join(
            f"{k} {host[k]:.3f} / {device[k]:.3f}" for k in stages))
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us > 0:
        log(f"[{tag}] profiler: device busy {busy_us / n:.1f} us/frame of "
            f"{wall_us / n:.1f} us/frame wall (idle share "
            f"{1 - busy_us / wall_us:.3f}); top kernels: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / n:.1f} us"
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[:6]))
    else:
        log(f"[{tag}] profiler: no device time recorded (not measured)")


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


# ---------------------------------------------------------------- phase 6

CLI_WALKERS = 6            # rows of bright blocks, alternating direction
CLI_START = 20             # frames of empty background before they walk
CLI_FRAMES = 56


def _cli_scene(i):
    """Frame i (BGR uint8, 720p) of the CLI's walker scene: a dark static
    background, then from frame CLI_START bright textured 120x90 blocks in
    separate rows walking 16 px a frame, alternately right and left, each
    crossing x = 640 once. The texture (values 160-255, so every pixel is
    bright) moves with its block, so background subtraction keeps it
    foreground, and the random-weight SSD finds boxes on it."""
    frame = np.full((FRAME_H, FRAME_W, 3), 16, np.uint8)
    if i >= CLI_START:
        for k, tex in enumerate(_CLI_TEXTURES):
            x, y = _cli_block(k, i)
            frame[y:y + 90, x:x + 120] = tex
    return frame


def _cli_block(k, i):
    """Top-left corner of walker k's block on frame i >= CLI_START."""
    right = k % 2 == 0
    return ((280 if right else 880) + (16 if right else -16) * (
        i - CLI_START), 40 + 110 * k)


_CLI_TEXTURES = np.random.RandomState(SEED + 10).randint(
    160, 256, (CLI_WALKERS, 90, 120, 3)).astype(np.uint8)


def _cli_expected():
    right = sum(1 for k in range(CLI_WALKERS) if k % 2 == 0)
    return {"poscount_person": right,
            "negcount_person": CLI_WALKERS - right,
            "diff_person": 2 * right - CLI_WALKERS,
            "intcount_person": CLI_WALKERS, "delcount_person": 0}


class _SceneCapture:
    """cv2.VideoCapture's interface over numpy frames (the CLI's path needs
    no cv2): read, get, set, release."""

    def __init__(self, n_frames):
        self.n, self.i = n_frames, 0

    def read(self):
        if self.i >= self.n:
            return False, None
        self.i += 1
        return True, _cli_scene(self.i - 1)

    def get(self, prop):
        from deepdish_tpu_torch.pipeline import runtime
        return {runtime.CAP_PROP_FRAME_WIDTH: FRAME_W,
                runtime.CAP_PROP_FRAME_HEIGHT: FRAME_H,
                runtime.CAP_PROP_FPS: 15.0}.get(prop, 0)

    def set(self, prop, value):
        return True

    def release(self):
        pass


def _run_cli(argv, n_frames=None):
    """deepdish_tpu_torch.pipeline.main.amain, with the scene's first
    n_frames through Pipeline._open_capture (None: the CLI opens its own
    input). Returns (pipeline, per-frame timing ms by label, frames seen by
    the frame step, non-finite frames)."""
    import asyncio

    from deepdish_tpu_torch.pipeline import main as cli
    from deepdish_tpu_torch.pipeline.elements import TimingInfo
    from deepdish_tpu_torch.pipeline.runtime import Pipeline
    seen = {"timing": {}, "frames": 0, "bad": 0}

    class SmokePipeline(Pipeline):
        def _open_capture(self, source):
            if n_frames is None:
                return super()._open_capture(source)
            return _SceneCapture(n_frames)

        def _device_step(self, frames_rgb):
            results = super()._device_step(frames_rgb)
            for out, snap in results:
                seen["frames"] += 1
                if not (np.isfinite(out.tlwh).all()
                        and np.isfinite(snap.tlwh).all()
                        and np.isfinite(snap.score).all()):
                    seen["bad"] += 1
            seen["pipeline"] = self
            return results

        def _text_output(self, handle, elements):
            for e in elements:
                if isinstance(e, TimingInfo):
                    seen["timing"].setdefault(e.short_label, []).append(
                        e.delta_t * 1e3)

    saved = cli.Pipeline
    cli.Pipeline = SmokePipeline
    try:
        asyncio.run(cli.amain(argv))
    finally:
        cli.Pipeline = saved
    return seen["pipeline"], seen["timing"], seen["frames"], seen["bad"]


@contextlib.contextmanager
def _float32_models():
    """The CLI's detectors and MARS in float32 on any device (the parity
    configuration; the card's default is bf16): compute_dtype bound into
    the registry's classes and the encoder factory while the block runs."""
    import torch
    from deepdish_tpu_torch.models import encoders, registry
    names = ("SSDMobileNetDetector", "YOLOv5Detector", "YOLOv3Detector",
             "EfficientDetLite0Detector")
    saved = [(registry, n, getattr(registry, n)) for n in names] + \
        [(encoders, "make_mars_encoder", encoders.make_mars_encoder)]
    for mod, name, obj in saved:
        setattr(mod, name, functools.partial(obj,
                                             compute_dtype=torch.float32))
    try:
        yield
    finally:
        for mod, name, obj in saved:
            setattr(mod, name, obj)


def _bgsub_card_vs_cpu(dev, frames):
    """The MOG2 update on the card against the CPU over the scene (its
    static background leaves most components at zero weight): per frame
    the mask agreement and the motion-ratio decision of every block and of
    random boxes; the state's largest difference at the end."""
    import torch
    from deepdish_tpu_torch.ops import bgsub
    rng = np.random.RandomState(SEED + 9)
    states = [bgsub.init_state(FRAME_H, FRAME_W, d)
              for d in (dev, torch.device("cpu"))]
    worst, flips, decisions = 1.0, 0, 0
    for i, f in enumerate(frames):
        masks = []
        for n, d in enumerate((dev, torch.device("cpu"))):
            states[n], m = bgsub.update(states[n],
                                        torch.from_numpy(f).to(d))
            masks.append(m.cpu().numpy())
        worst = min(worst, float((masks[0] == masks[1]).mean()))
        sizes = rng.randint(8, 200, size=(32, 2))
        boxes = [(rng.randint(0, FRAME_W - w), rng.randint(0, FRAME_H - h),
                  int(w), int(h)) for w, h in sizes]
        if i >= CLI_START:
            boxes += [_cli_block(k, i) + (120, 90)
                      for k in range(CLI_WALKERS)]
        got = [_motion(masks[0], b) for b in boxes]
        flips += sum(a != b for a, b in zip(got, [_motion(masks[1], b)
                                                  for b in boxes]))
        decisions += len(boxes)
    _sync(dev)
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(states[0][:3], states[1][:3]))
    return worst, flips, decisions, err


def _motion(mask, box, ratio=0.25):
    x, y, w, h = box
    return bool((mask[y:y + h, x:x + w] != 0).sum() >= ratio * w * h)


def _to_i420(frames_rgb):
    """(F, H, W, 3) RGB -> (F, H*3/2, W) I420 with BT.601 video-range
    coefficients, in numpy (the port's path needs no cv2)."""
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


def phase_cli(dev):
    """The port's CLI end to end on the card, and the bgsub pieces under
    it; every LSAP count is reset before its run and read after."""
    import tempfile

    import torch
    from deepdish_tpu_torch import device as devmod
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import COCO_LABELS
    from deepdish_tpu_torch.ops import colorspace
    from deepdish_tpu_torch.pipeline import FrameStepConfig

    frames_bgr = np.stack([_cli_scene(i) for i in range(CLI_FRAMES)])
    frames_rgb = np.ascontiguousarray(frames_bgr[..., ::-1])
    worst, flips, decisions, err = _bgsub_card_vs_cpu(dev, frames_rgb[:36])
    log(f"[cli] bgsub 720p card vs CPU over 36 frames: masks agree on >= "
        f"{worst:.6f} of the pixels on every frame; {flips} of {decisions} "
        f"motion decisions differ; state max |card - CPU| {err:.3e}")
    if worst < 0.999 or flips:
        raise SystemExit("cli: bgsub on the card disagrees with the CPU")

    # FrameStep.step with bgsub on (the CLI's default) and off (phase 5's
    # configuration), same weights and frames, in turns; then
    # run_chunk_yuv against run_chunk
    from deepdish_tpu_torch.pipeline import FrameStep
    fs = _framestep(dev, (FRAME_H, FRAME_W),
                    step_cfg=FrameStepConfig(background_subtraction=True))
    fs_off = FrameStep(fs.detector, fs.encoder, fs.tracker_cfg,
                       fs.wanted_labels, (FRAME_H, FRAME_W), device=dev)
    warm = {}
    for name, f_s in (("on", fs), ("off", fs_off)):
        st = f_s.init_state()
        for f in frames_rgb[:CLI_START]:     # MOG2 learns the background
            st, _, _, _ = f_s.step(st, f)
        warm[name] = st
    _sync(dev)
    seq = frames_rgb[CLI_START:CLI_START + 16]
    for name in ("on", "off", "on", "off"):
        f_s = fs if name == "on" else fs_off
        state = warm[name]
        lsap.launches = 0
        devmod.host_syncs = 0
        dets = []
        t0 = time.perf_counter()
        for f in seq:
            state, out, snap, _ = f_s.step(state, f)
            dets.append(snap.valid.sum())
        _sync(dev)
        step_ms = (time.perf_counter() - t0) / len(seq) * 1e3
        log(f"[cli] FrameStep.step, bgsub {name}, 720p walker scene: "
            f"{step_ms:.3f} ms/frame over {len(seq)} frames, "
            f"{devmod.host_syncs / len(seq):.2f} host syncs/frame, "
            f"{lsap.launches} LSAP launches, detections/frame "
            f"{[int(d) for d in dets]}")
        _check_outputs(out, snap, 64, 32)
    state = warm["on"]
    profile_step(fs, seq[:8], dev, tag="cli", state=state)

    chunk = frames_rgb[CLI_START:CLI_START + 8]
    yuv = _to_i420(chunk)
    rgb_dev = colorspace.yuv420_to_rgb_u8(torch.from_numpy(yuv).to(dev),
                                          FRAME_H, FRAME_W)
    rgb = rgb_dev.cpu().numpy()
    ys, yo, ysnap = fs.run_chunk_yuv(state, yuv)
    rs, ro, rsnap = fs.run_chunk(state, rgb)
    same = all(torch.equal(a, b) for a, b in zip(yo + ysnap, ro + rsnap))
    times = {}
    for name, fn in (("run_chunk", lambda: fs.run_chunk(state, rgb)),
                     ("run_chunk_yuv", lambda: fs.run_chunk_yuv(state, yuv)),
                     ("run_chunk again", lambda: fs.run_chunk(state, rgb)),
                     ("run_chunk_yuv again",
                      lambda: fs.run_chunk_yuv(state, yuv))):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times[name] = (time.perf_counter() - t0) / len(chunk) * 1e3
    log(f"[cli] run_chunk_yuv(8) vs run_chunk(8) on the frames it converts "
        f"them to: outputs identical {same}; ms/frame (host clock, from "
        f"host numpy frames, in turns): " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()))
    if not same:
        raise SystemExit("cli: run_chunk_yuv differs from run_chunk")
    del fs, state, ys, rs

    common = ["--input", "synthetic://walkers", "--disable-graphics",
              "--streaming", "0", "--control-port", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        # Run 1: the default configuration, every COCO label wanted
        for chunk_size in (1, 8):
            lsap.launches = 0
            t0 = time.perf_counter()
            pipe, timing, n, bad = _run_cli(
                common + ["--model", "ssd_mobilenet",
                          "--wanted-labels", ",".join(COCO_LABELS),
                          "--chunk-size", str(chunk_size),
                          "--log", f"{tmp}/default{chunk_size}.log"],
                CLI_FRAMES)
            secs = time.perf_counter() - t0
            skip = 8      # the first frames carry the start-up
            objd = float(np.mean(timing["objd"][skip:]))
            e2e = float(np.mean(timing["e2e"][skip:]))
            crossed = {k: v for k, v in
                       pipe.counting.counters_payload().items() if v}
            log(f"[cli] default CLI 720p (ssd_mobilenet + MARS random-init, "
                f"bgsub on, {pipe.framestep.detector.compute_dtype}), "
                f"--chunk-size {chunk_size}: {n} frames in {secs:.1f} s, "
                f"objd {objd:.3f} ms/frame, e2e {e2e:.3f} ms/frame (mean "
                f"over frames {skip + 1}-{n}), {lsap.launches} LSAP "
                f"launches, {bad} frames with non-finite outputs; nonzero "
                f"counters {crossed}")
            if n != CLI_FRAMES or bad:
                raise SystemExit(f"cli: the default run saw {n} frames, "
                                 f"{bad} non-finite")
            del pipe

        # Run 1b: the same in float32, on the card and on the CPU, at
        # chunk 1 and 8: the card must count what the CPU counts
        f32 = {}
        for where in (dev.type, "cpu"):
            for chunk_size in (1, 8):
                lsap.launches = 0
                t0 = time.perf_counter()
                with _float32_models():
                    pipe, timing, n, bad = _run_cli(
                        common + ["--model", "ssd_mobilenet",
                                  "--wanted-labels", ",".join(COCO_LABELS),
                                  "--device", where,
                                  "--chunk-size", str(chunk_size),
                                  "--log", f"{tmp}/f32_{where}{chunk_size}"
                                  ".log"], CLI_FRAMES)
                f32[where, chunk_size] = {
                    k: v for k, v in
                    pipe.counting.counters_payload().items() if v}
                log(f"[cli] default CLI in float32 on {where}, --chunk-size "
                    f"{chunk_size}: {n} frames in "
                    f"{time.perf_counter() - t0:.1f} s, {lsap.launches} "
                    f"LSAP launches, {bad} non-finite; nonzero counters "
                    f"{f32[where, chunk_size]}")
                if n != CLI_FRAMES or bad:
                    raise SystemExit(f"cli: the float32 run saw {n} frames, "
                                     f"{bad} non-finite")
                del pipe
        for chunk_size in (1, 8):
            if f32[dev.type, chunk_size] != f32["cpu", chunk_size]:
                raise SystemExit(
                    f"cli: float32 counters differ between the card and the "
                    f"CPU at --chunk-size {chunk_size}: {f32}")
        same = f32["cpu", 1] == f32["cpu", 8]
        log(f"[cli] float32 counters: card == CPU at --chunk-size 1 and 8; "
            f"chunk 1 vs 8 {'equal' if same else 'differ'}")

        # Run 2: scripted:bright, card then CPU
        counts = {}
        for where in ("cuda", "cpu"):
            lsap.launches = 0
            t0 = time.perf_counter()
            pipe, timing, n, bad = _run_cli(
                common + ["--model", "scripted:bright", "--device", where,
                          "--max-detections", "8",
                          "--log", f"{tmp}/scripted_{where}.log"],
                CLI_FRAMES)
            counts[where] = pipe.counting.counters_payload()
            launches = lsap.launches
            log(f"[cli] scripted:bright on {where}: {n} frames in "
                f"{time.perf_counter() - t0:.1f} s, objd "
                f"{float(np.mean(timing['objd'][8:])):.3f} ms/frame, "
                f"{launches} LSAP launches; counters {counts[where]}")
            if where == "cuda" and launches <= 0:
                raise SystemExit("cli: the LSAP kernel never launched")
            if n != CLI_FRAMES or bad:
                raise SystemExit(f"cli: scripted run saw {n} frames, "
                                 f"{bad} non-finite")
    expected = _cli_expected()
    log(f"[cli] expected crossings {expected}")
    if counts["cuda"] != expected or counts["cpu"] != expected:
        raise SystemExit(f"cli: counters {counts}, expected {expected}")


# ---------------------------------------------------------------- phase 7

FAMILY_MODELS = ("yolov5s", "yolov3", "efficientdet-lite0")
FAMILY_THRESHOLD = 0.3     # detector and pipeline score threshold


def _calibration_images(h=256, w=256):
    """Two frames of the walker scene resized to h x w and two seeded noise
    images (NHWC float32 in [0, 255]): the inputs on which the random
    donors' batch norms are calibrated."""
    import torch
    scene = np.stack([_cli_scene(CLI_START + k)[..., ::-1]
                      for k in (4, 20)]).astype(np.float32)
    return torch.cat([
        torch.nn.functional.interpolate(
            torch.from_numpy(scene).permute(0, 3, 1, 2), size=(h, w),
            mode="bilinear").permute(0, 2, 3, 1),
        torch.from_numpy(np.random.RandomState(SEED + 20).randint(
            0, 256, (2, h, w, 3)).astype(np.float32))])


def _calibrated_init(module, generator, image):
    """flax's default draw (the port's `flax_default_init_`), then every
    batch norm's statistics set to those of its input on `image`."""
    import torch
    from deepdish_tpu_torch.models import layers

    def set_stats(bn, args):
        x = args[0]
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        bn.running_mean.copy_(x.mean(dims))
        bn.running_var.copy_(x.var(dims, unbiased=False))

    layers.flax_default_init_(module, generator)
    hooks = [m.register_forward_pre_hook(set_stats)
             for m in module.modules()
             if isinstance(m, layers.BatchNorm)]
    try:
        with torch.no_grad():
            module(image)
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def _family_init():
    """Random-init weights for the families phase: flax's default draw
    (the port's `flax_default_init_`), then every batch norm's statistics
    set to those of its input on two frames of the walker scene and two
    seeded noise images (256 x 256), so that each normalizes to mean 0 and
    variance 1 there (the noise keeps channels that are flat on the dark
    scene from being scaled up by 1 / sqrt(1e-3)). With flax's default alone the
    signal vanishes or explodes through the depth (YOLOv5s's heads are ~0
    on the walker scene, every score 0.25 within 2e-4, on its 0.25 floor;
    YOLOv3's saturate at 1), and a small change in the draw flips which;
    calibrated, the heads are O(1) and the scores spread. Applies to the
    three families' constructors while the block runs."""
    from deepdish_tpu_torch.models import efficientdet, layers, yolov3, yolov5
    image = _calibration_images()

    def init(module, generator):
        _calibrated_init(module, generator, image)
    mods = (yolov5, yolov3, efficientdet)
    for m in mods:
        m.flax_default_init_ = init
    try:
        yield
    finally:
        for m in mods:
            m.flax_default_init_ = layers.flax_default_init_


def _tie_groups(scores, rel=1e-5):
    """Slot ranges [a, b) whose consecutive scores lie within `rel` of each
    other: the card and the CPU may order such slots either way."""
    groups, a = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or \
                abs(scores[i] - scores[i - 1]) > rel * abs(scores[i - 1]):
            groups.append((a, i))
            a = i
    return groups


def _compare_detections(card, cpu):
    """One frame's detector outputs (boxes, classes, scores, valid) from
    the card and the CPU: the same valid count, and slot by slot the same
    class, score and box, except that within a run of scores tied to 1e-5
    (`_tie_groups` of the CPU's) the rows may come in either order, so
    each side's run is sorted by (class, x1) first. Returns (problems, max
    score error, max box error relative to the largest box coordinate:
    random-weight boxes reach thousands of pixels)."""
    (cb, cc, cs, cv), (pb, pc, ps, pv) = card, cpu
    if cv.sum() != pv.sum():
        return [f"{cv.sum()} valid on the card, {pv.sum()} on the CPU"], \
            float("inf"), float("inf")
    n = int(pv.sum())
    problems = [] if (cv[:n].all() and pv[:n].all()) else \
        ["valid slots are not the first ones"]
    scale = max(float(np.abs(pb[:n]).max(initial=0)), 1.0)
    serr = berr = 0.0
    for a, b in _tie_groups(ps[:n]):
        oc = a + np.lexsort((cb[a:b, 0], cc[a:b]))
        op = a + np.lexsort((pb[a:b, 0], pc[a:b]))
        if not np.array_equal(cc[oc], pc[op]):
            problems.append(f"classes differ in slots {a}-{b}")
            continue
        serr = max(serr, float(np.abs(cs[oc] - ps[op]).max()))
        berr = max(berr, float(np.abs(cb[oc] - pb[op]).max()) / scale)
    return problems, serr, berr


def phase_families(dev):
    """YOLOv5s (320), YOLOv3 (416) and EfficientDet-Lite0 (320) at full
    width on the walker scene: float32 detector outputs on the card against
    the CPU port on the same resized 720p frames; FrameStep `step` and
    `run_chunk` in bf16 (ms/frame, syncs/frame, LSAP launches); one CLI run
    at --chunk-size 8. Returns the LSAP launches of the frame-step runs."""
    import tempfile

    import torch
    from deepdish_tpu_torch import device as devmod
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import COCO_LABELS, create_detector
    from deepdish_tpu_torch.pipeline import FrameStepConfig

    frames_rgb = np.ascontiguousarray(np.stack(
        [_cli_scene(i) for i in range(CLI_FRAMES)])[..., ::-1])
    shape = (FRAME_H, FRAME_W)
    step_cfg = FrameStepConfig(score_threshold=FAMILY_THRESHOLD)
    cpu = torch.device("cpu")
    launches_total = 0
    for name in FAMILY_MODELS:
        t_phase = time.perf_counter()
        # 1. float32, card against the CPU port, two frames with blocks
        outs = []
        with _family_init():
            for where in (dev, cpu):
                det = create_detector(
                    name, device=where, compute_dtype=torch.float32,
                    score_threshold=FAMILY_THRESHOLD,
                    generator=torch.Generator().manual_seed(SEED))
                if where == dev:     # the card resizes (and letterboxes)
                    fs = _framestep(where, shape, step_cfg=step_cfg,
                                    detector=det)
                    inputs = fs.detector_input(torch.from_numpy(
                        frames_rgb[CLI_START + 6::12][:2]).to(dev)).cpu()
                    del fs
                elif getattr(det, "letterbox", False):
                    det.configure_letterbox(FRAME_W, FRAME_H)
                with torch.inference_mode():
                    raw = det.detect(inputs.to(where), float(FRAME_W),
                                     float(FRAME_H))
                outs.append([x.cpu().numpy() for x in raw])
                del det
        report, serr, berr = [], 0.0, 0.0
        for i in range(len(inputs)):
            p, se, be = _compare_detections(*([x[i] for x in o]
                                              for o in outs))
            report += [f"frame {i}: {m}" for m in p]
            serr, berr = max(serr, se), max(berr, be)
        n_valid = [int(v.sum()) for v in outs[1][3]]
        log(f"[families] {name} float32 detect, card vs CPU on "
            f"{len(inputs)} resized 720p frames ({tuple(inputs.shape[1:3])}"
            f"), valid {n_valid}: {len(report)} problems, max |score| "
            f"error {serr:.3e}, max box error {berr:.3e} of the largest "
            f"box coordinate")
        # float32 sums in another order through ~60-130 layers of random
        # weights: the CPU's own float32 outputs differ from float64 by up
        # to 1e-4 of the range (EfficientDet-Lite0), which the box
        # decode's exp carries into the boxes
        if report or serr > 1e-4 or berr > 1e-3 or min(n_valid) <= 0:
            raise SystemExit(f"families: {name} float32 card vs CPU: "
                             f"{report[:6]}")

        # 2. bf16 FrameStep: step over 16 frames, run_chunk over 8
        with _family_init():
            det = create_detector(
                name, device=dev, score_threshold=FAMILY_THRESHOLD,
                generator=torch.Generator().manual_seed(SEED))
        fs = _framestep(dev, shape, step_cfg=step_cfg, detector=det)
        seq = frames_rgb[CLI_START:CLI_START + 16]
        chunk = frames_rgb[CLI_START + 16:CLI_START + 24]
        state = fs.init_state()
        for f in frames_rgb[CLI_START - 2:CLI_START]:     # warm-up
            state, out, snap, _ = fs.step(state, f)
        fs.run_chunk(fs.init_state(), chunk)
        _sync(dev)
        lsap.launches = 0
        devmod.host_syncs = 0
        dets = []
        t0 = time.perf_counter()
        for f in seq:
            state, out, snap, _ = fs.step(state, f)
            dets.append(snap.valid.sum())
        _sync(dev)
        step_ms = (time.perf_counter() - t0) / len(seq) * 1e3
        step_syncs = devmod.host_syncs / len(seq)
        step_launches = lsap.launches
        _check_outputs(out, snap, 64, 32)
        devmod.host_syncs = 0
        t0 = time.perf_counter()
        state, couts, csnaps = fs.run_chunk(state, chunk)
        _sync(dev)
        chunk_ms = (time.perf_counter() - t0) / len(chunk) * 1e3
        chunk_syncs = devmod.host_syncs / len(chunk)
        _check_outputs(couts, csnaps, 64, 32)
        launches = lsap.launches
        launches_total += launches
        log(f"[families] {name} bf16 FrameStep 720p (input "
            f"{det.width}x{det.height}, score threshold {FAMILY_THRESHOLD}, "
            f"bgsub off): step {step_ms:.3f} ms/frame, {step_syncs:.2f} host "
            f"syncs/frame, detections/frame {[int(d) for d in dets]}; "
            f"run_chunk(8) {chunk_ms:.3f} ms/frame, {chunk_syncs:.2f} host "
            f"syncs/frame; LSAP launches {step_launches} in step, "
            f"{launches - step_launches} in run_chunk")
        if launches <= 0:
            raise SystemExit(f"families: {name}: the LSAP kernel never "
                             "launched")
        del fs, det, state

        # 3. the CLI at --chunk-size 8 (bgsub on, the CLI default)
        lsap.launches = 0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, _family_init():
            pipe, timing, n, bad = _run_cli(
                ["--input", "synthetic://walkers", "--disable-graphics",
                 "--streaming", "0", "--control-port", "0",
                 "--model", name, "--wanted-labels", ",".join(COCO_LABELS),
                 "--device", dev.type,
                 "--score-threshold", str(FAMILY_THRESHOLD),
                 "--chunk-size", "8", "--log", f"{tmp}/{name}.log"],
                CLI_FRAMES)
        skip = 8
        counters = {k: v for k, v in
                    pipe.counting.counters_payload().items() if v}
        log(f"[families] {name} CLI 720p --chunk-size 8 "
            f"({pipe.framestep.detector.compute_dtype}, bgsub on): {n} "
            f"frames in {time.perf_counter() - t0:.1f} s, objd "
            f"{float(np.mean(timing['objd'][skip:])):.3f} ms/frame, e2e "
            f"{float(np.mean(timing['e2e'][skip:])):.3f} ms/frame (mean over "
            f"frames {skip + 1}-{n}), {lsap.launches} LSAP launches, {bad} "
            f"frames with non-finite outputs; nonzero counters {counters}; "
            f"{name} took {time.perf_counter() - t_phase:.1f} s")
        if n != CLI_FRAMES or bad:
            raise SystemExit(f"families: {name} CLI saw {n} frames, {bad} "
                             "non-finite")
        del pipe
    return launches_total


# ---------------------------------------------------------------- phase 8

CVAT_FIRST, CVAT_FRAMES = CLI_START - 2, 28
CVAT_WALKER = 1            # the annotated walker


def _write_cvat_input(d):
    """The walker scene's frames CVAT_FIRST.. as images/frame_%06d.jpg
    from 1, and an annotations.xml with one person track on walker
    CVAT_WALKER's block while it is in the scene."""
    import os
    import xml.etree.ElementTree as ET

    import cv2
    os.makedirs(f"{d}/images")
    for j in range(CVAT_FRAMES):
        cv2.imwrite(f"{d}/images/frame_{j + 1:06d}.jpg",
                    _cli_scene(CVAT_FIRST + j))
    root = ET.Element("annotations")
    labels = ET.SubElement(ET.SubElement(ET.SubElement(
        root, "meta"), "task"), "labels")
    lab = ET.SubElement(labels, "label")
    ET.SubElement(lab, "name").text = "person"
    ET.SubElement(lab, "color").text = "#ff0000"
    track = ET.SubElement(root, "track", attrib={"id": "1",
                                                 "label": "person"})
    for j in range(CVAT_FRAMES):
        i = CVAT_FIRST + j
        if i < CLI_START:
            continue
        x, y = _cli_block(CVAT_WALKER, i)
        ET.SubElement(track, "box", attrib={
            "frame": str(j + 1), "outside": "0", "occluded": "0",
            "keyframe": "1", "z_order": "0", "xtl": str(x), "ytl": str(y),
            "xbr": str(x + 120), "ybr": str(y + 90)})
    ET.ElementTree(root).write(f"{d}/annotations.xml")


def _bright_detect_only(self, state, frame_rgb):
    """FrameStep.detect_only replaced by the bright-block script
    (models.registry's scripted:bright boxes), on the frame step's device:
    the same boxes on the card and the CPU."""
    import torch
    from deepdish_tpu_torch.models.registry import _bright_blob_script
    from deepdish_tpu_torch.pipeline import DetectionSnapshot
    D = self.tracker_cfg.max_detections
    boxes, _, scores = _bright_blob_script(np.asarray(frame_rgb))
    tlwh = np.zeros((D, 4), np.float32)
    score = np.zeros((D,), np.float32)
    valid = np.zeros((D,), bool)
    for i, (b, sc) in enumerate(zip(boxes[:D], scores)):
        tlwh[i], score[i], valid[i] = b, sc, True
    return state.bg, DetectionSnapshot(*(
        torch.from_numpy(a).to(self.device)
        for a in (tlwh, np.zeros((D,), np.int32), score, valid)))


def phase_cvat(dev):
    """CVAT split mode through the CLI on a JPEG sequence of the walker
    scene with one annotated track: float32 with a scripted detect_only on
    the card and on the CPU (identical annotations.xml), then the random
    SSD in bf16 on the card. Returns the card runs' LSAP launches."""
    import os
    import tempfile

    from deepdish_tpu_torch import device as devmod
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import COCO_LABELS
    from deepdish_tpu_torch.pipeline import FrameStep

    common = ["--disable-graphics", "--streaming", "0", "--control-port",
              "0", "--max-detections", "8"]
    xmls, launches_total = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        _write_cvat_input(f"{tmp}/in")
        saved = FrameStep.detect_only
        FrameStep.detect_only = _bright_detect_only
        try:
            for where in (dev.type, "cpu"):
                lsap.launches = 0
                devmod.host_syncs = 0
                t0 = time.perf_counter()
                with _float32_models():
                    pipe, timing, n, bad = _run_cli(common + [
                        "--input-cvat-dir", f"{tmp}/in",
                        "--output-cvat-dir", f"{tmp}/out_{where}",
                        "--model", "scripted:noop", "--encoder-model",
                        "mars", "--wanted-labels", "person",
                        "--device", where])
                with open(f"{tmp}/out_{where}/annotations.xml", "rb") as f:
                    xmls[where] = f.read()
                if where == dev.type:
                    launches_total += lsap.launches
                log(f"[cvat] float32, scripted detect_only, on {where}: {n} "
                    f"frames in {time.perf_counter() - t0:.1f} s, objd "
                    f"{float(np.mean(timing['objd'][4:])):.3f} ms/frame, "
                    f"{devmod.host_syncs / max(n, 1):.2f} host syncs/frame, "
                    f"{lsap.launches} LSAP launches, {bad} non-finite; "
                    f"{xmls[where].count(b'<track ')} tracks, "
                    f"{xmls[where].count(b'<box ')} boxes in "
                    "annotations.xml")
                if n != CVAT_FRAMES or bad:
                    raise SystemExit(f"cvat: the {where} run saw {n} "
                                     f"frames, {bad} non-finite")
                del pipe
        finally:
            FrameStep.detect_only = saved
        card = xmls[dev.type]
        if card != xmls["cpu"] or b'source="manual"' not in card or \
                b'source="automatic"' not in card:
            raise SystemExit("cvat: the card's annotations.xml differs from "
                             "the CPU's (or lacks manual/automatic tracks)")
        log("[cvat] annotations.xml identical on the card and the CPU "
            f"({len(card)} bytes)")
        if launches_total <= 0:
            raise SystemExit("cvat: the LSAP kernel never launched")

        lsap.launches = 0
        devmod.host_syncs = 0
        t0 = time.perf_counter()
        pipe, timing, n, bad = _run_cli(common + [
            "--input-cvat-dir", f"{tmp}/in", "--output-cvat-dir",
            f"{tmp}/out_ssd", "--device", dev.type, "--model", "ssd_mobilenet",
            "--wanted-labels", ",".join(COCO_LABELS)])
        out = f"{tmp}/out_ssd/annotations.xml"
        with open(out, "rb") as f:
            xml = f.read()
        log(f"[cvat] random SSD + MARS in "
            f"{pipe.framestep.detector.compute_dtype} on the card: {n} "
            f"frames in {time.perf_counter() - t0:.1f} s, objd "
            f"{float(np.mean(timing['objd'][4:])):.3f} ms/frame, "
            f"{devmod.host_syncs / max(n, 1):.2f} host syncs/frame, "
            f"{lsap.launches} LSAP launches, {bad} non-finite; "
            f"{xml.count(b'<track ')} tracks in annotations.xml "
            f"({os.path.getsize(out)} bytes)")
        if n != CVAT_FRAMES or bad or lsap.launches <= 0:
            raise SystemExit(f"cvat: the SSD run saw {n} frames, {bad} "
                             f"non-finite, {lsap.launches} LSAP launches")
        launches_total += lsap.launches
    return launches_total


# ---------------------------------------------------------------- phase 9

FRCNN_THRESHOLD = 0.3      # detector and pipeline score threshold
FRCNN_LOGIT_STD = (3.0, 4.0)   # RPN objectness, second-stage class logits
FRCNN_STAGES = ("framestep.upload", "framestep.resize", "frcnn.trunk",
                "frcnn.rpn_nms", "frcnn.crop_block4", "frcnn.second_nms",
                "framestep.filter_nms", "framestep.crop_mars",
                "framestep.tracker")


def _frcnn_donor(dev):
    """Full-width Faster R-CNN weights (FasterRCNNConfig(): ResNet-101 C4
    at 640, 90 classes): flax's default draw from SEED, then, in float32
    on the card, every batch norm's statistics set to those of its input
    on two walker frames and two seeded noise images at 640 (as
    `_family_init` does), and the RPN objectness and class heads scaled so
    that their logits have the standard deviations FRCNN_LOGIT_STD there
    (flax's draw alone gives scores that tie to 1e-6 or saturate).
    Returns the config and the state_dict on the host."""
    import torch
    from deepdish_tpu_torch.models import faster_rcnn as fr
    from deepdish_tpu_torch.models import layers
    from deepdish_tpu_torch.models.preprocess import resize_bilinear_mxu
    cfg = fr.FasterRCNNConfig()
    net = fr.FasterRCNNNet(cfg)
    layers.flax_default_init_(net, torch.Generator().manual_seed(SEED))
    net = net.to(dev).eval()
    net.reset_constants()
    size = cfg.input_size
    scene = torch.from_numpy(np.ascontiguousarray(np.stack(
        [_cli_scene(CLI_START + k)[..., ::-1] for k in (4, 20)]))).to(dev)
    images = torch.cat([
        resize_bilinear_mxu(scene, size, size, torch.float32),
        torch.from_numpy(np.random.RandomState(SEED + 30).randint(
            0, 256, (2, size, size, 3)).astype(np.float32)).to(dev)])

    def set_stats(bn, args):
        bn.running_mean.copy_(args[0].mean((0, 2, 3)))
        bn.running_var.copy_(args[0].var((0, 2, 3), unbiased=False))
    logits = {}

    def keep(name):
        def hook(module, args, out):
            logits[name] = out
        return hook
    hooks = [m.register_forward_pre_hook(set_stats) for m in net.modules()
             if isinstance(m, layers.BatchNorm)]
    hooks += [net.rpn_cls.register_forward_hook(keep("rpn")),
              net.cls_head.register_forward_hook(keep("cls"))]
    try:
        with torch.no_grad():
            net(images)
            # objectness is the difference of the two logits per anchor
            rpn = logits["rpn"].permute(0, 2, 3, 1).reshape(-1, 2)
            for layer, spread, target in (
                    (net.rpn_cls, rpn[:, 1] - rpn[:, 0], FRCNN_LOGIT_STD[0]),
                    (net.cls_head, logits["cls"], FRCNN_LOGIT_STD[1])):
                k = target / float(spread.float().std())
                layer.weight.mul_(k)
                layer.bias.mul_(k)
    finally:
        for h in hooks:
            h.remove()
    return cfg, {k: v.cpu() for k, v in net.state_dict().items()}


def _tfod_named(flat, cfg):
    """Flat flax variables of a Faster R-CNN as the TF-OD
    faster_rcnn_resnet_v1 graph names that convert_faster_rcnn_tfod reads
    (resnet_v1_<3 * units + 2>)."""
    rv = f"resnet_v1_{3 * sum(cfg.block_units) + 2}"
    names = {}

    def put(tf_name, flax_name, bias=False):
        names[f"{tf_name}/weights"] = flat[f"params/{flax_name}/kernel"]
        if bias:
            names[f"{tf_name}/biases"] = flat[f"params/{flax_name}/bias"]
            return
        bn = f"{flax_name}_bn"
        for tfv, key in (("gamma", f"params/{bn}/scale"),
                         ("beta", f"params/{bn}/bias"),
                         ("moving_mean", f"batch_stats/{bn}/mean"),
                         ("moving_variance", f"batch_stats/{bn}/var")):
            names[f"{tf_name}/BatchNorm/{tfv}"] = flat[key]

    put(f"FirstStageFeatureExtractor/{rv}/conv1", "conv1")
    for b in range(1, 5):
        stage = ("FirstStageFeatureExtractor" if b <= 3
                 else "SecondStageFeatureExtractor")
        for u in range(1, cfg.block_units[b - 1] + 1):
            tf_u = f"{stage}/{rv}/block{b}/unit_{u}/bottleneck_v1"
            for c in ("conv1", "conv2", "conv3", "shortcut"):
                if f"params/block{b}/unit_{u}/{c}/kernel" in flat:
                    put(f"{tf_u}/{c}", f"block{b}/unit_{u}/{c}")
    put("Conv", "rpn_conv", bias=True)
    put("FirstStageBoxPredictor/BoxEncodingPredictor", "rpn_box", bias=True)
    put("FirstStageBoxPredictor/ClassPredictor", "rpn_cls", bias=True)
    put("SecondStageBoxPredictor/BoxEncodingPredictor", "box_head",
        bias=True)
    put("SecondStageBoxPredictor/ClassPredictor", "cls_head", bias=True)
    return names


def _frcnn_second_stage(net, fmap, proposals, prop_valid, modes):
    """The second stage of `net` on the given fmap and proposals, per
    second-stage mode, as host numpy (boxes, classes, scores, valid)."""
    import dataclasses
    base, out = net.cfg, {}
    for mode in modes:
        net.cfg = dataclasses.replace(base, second_stage_mode=mode)
        out[mode] = [x.cpu().numpy() for x in net.second_stage(
            fmap, proposals, prop_valid)]
    net.cfg = base
    return out


def _rel_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def _frcnn_card_vs_cpu(card, host, inputs, modes):
    """Float32 Faster R-CNN on the card against the CPU port, stage by
    stage: the trunk and the RPN heads from the same images (within 1e-3
    of their range); the proposal selection on the CPU from the card's heads (the
    same valid slots, proposals within 1e-5); each second-stage mode on
    the CPU from the card's fmap and proposals (`_compare_detections`).
    The selection from each side's own heads is reported, not held: on
    random weights objectness values of overlapping anchors lie within
    float32 noise of each other, and greedy NMS keeps either one.
    Returns (problems, log lines)."""
    import torch
    with torch.inference_mode():
        fmap_c = card.net.trunk(inputs.to(card.device))
        heads_c = card.net.rpn_heads(fmap_c)
        props_c = card.net.select_proposals(*heads_c)
        out_c = _frcnn_second_stage(card.net, fmap_c, *props_c, modes)
        fmap_p = host.net.trunk(inputs)
        heads_p = host.net.rpn_heads(fmap_p)
        own_p = host.net.select_proposals(*heads_p)
        props_x = host.net.select_proposals(*(h.cpu() for h in heads_c))
        out_p = _frcnn_second_stage(host.net, fmap_c.cpu(),
                                    *(p.cpu() for p in props_c), modes)
    errs = {"fmap": _rel_err(fmap_c, fmap_p),
            "rpn_box": _rel_err(heads_c[0], heads_p[0]),
            "rpn_cls": _rel_err(heads_c[1], heads_p[1]),
            "proposals": float((props_x[0] - props_c[0].cpu()).abs().max())}
    # ResNet-101's ~100 float32 convolutions summed in other orders by
    # cuDNN and the CPU: the trunk and heads differ by ~2e-4 of their range
    # (the families' 60-130 layers: 1e-4), the selection on equal heads by
    # ulps
    bounds = {"fmap": 1e-3, "rpn_box": 1e-3, "rpn_cls": 1e-3,
              "proposals": 1e-5}
    problems = [f"{k} error {v:.3e}" for k, v in errs.items()
                if v > bounds[k]]
    if not torch.equal(props_x[1], props_c[1].cpu()):
        problems.append("prop_valid differs on the card's heads")
    own_same = ((own_p[0] - props_c[0].cpu()).abs().amax(-1) < 1e-4)
    lines = [f"trunk and RPN heads, relative errors {errs['fmap']:.3e} / "
             f"{errs['rpn_box']:.3e} / {errs['rpn_cls']:.3e} (fmap / box / "
             f"objectness); selection on the card's heads: prop_valid "
             f"equal, proposals within {errs['proposals']:.3e}; from each "
             f"side's own heads {int(own_same.sum())} of "
             f"{own_same.numel()} proposal slots agree within 1e-4"]
    for mode in modes:
        serr = berr = 0.0
        for i in range(len(inputs)):
            p, se, be = _compare_detections(
                *([x[i] for x in o[mode]] for o in (out_c, out_p)))
            problems += [f"{mode} frame {i}: {m}" for m in p]
            serr, berr = max(serr, se), max(berr, be)
        n_valid = [int(v.sum()) for v in out_p[mode][3]]
        lines.append(f"second stage {mode} on the card's fmap and "
                     f"proposals: valid {n_valid}, max |score| error "
                     f"{serr:.3e}, max box error {berr:.3e} (normalised)")
        if serr > 1e-4 or berr > 1e-4 or min(n_valid) <= 0:
            problems.append(f"{mode}: errors {serr}, {berr}, valid "
                            f"{n_valid}")
    return problems, lines


def _frcnn_labels(n):
    """n class names in id order: COCO's 80, then coco_<id>."""
    from deepdish_tpu_torch.models import COCO_LABELS
    return [COCO_LABELS[i] if i < len(COCO_LABELS) else f"coco_{i + 1}"
            for i in range(n)]


def _write_pbtxt(path, names):
    """A TF-OD label map with 1-based ids."""
    with open(path, "w") as f:
        for i, name in enumerate(names):
            f.write(f'item {{\n  id: {i + 1}\n  name: "{name}"\n}}\n')


def phase_frcnn(dev):
    """Faster R-CNN (ResNet-101 C4 at 640) at full width: float32 card
    against the CPU port in both second-stage modes; the TF-free name-map
    conversion at resnet_v1_101 identical on the card; FrameStep `step`
    and `run_chunk(8)` in bf16 (ms/frame, syncs/frame, LSAP launches, the
    profiler's stage split); the CLI on a .npz and a .pbtxt at
    --chunk-size 8. Returns the LSAP launches of the frame-step runs and
    the CLI."""
    import dataclasses
    import tempfile

    import torch
    from deepdish_tpu_torch import device as devmod
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import convert as cvm
    from deepdish_tpu_torch.models import weights as wm
    from deepdish_tpu_torch.models.faster_rcnn import (FasterRCNNDetector,
                                                       FasterRCNNNet)
    from deepdish_tpu_torch.pipeline import FrameStepConfig

    t0 = time.perf_counter()
    cfg, sd = _frcnn_donor(dev)
    log(f"[frcnn] ResNet-v1 C4 {cfg.block_units} at {cfg.input_size}, "
        f"widths {cfg.block_features}, {cfg.num_classes} "
        f"classes, pre_nms_topk {cfg.pre_nms_topk}, {cfg.max_proposals} "
        f"proposals; seeded weights with batch norms calibrated on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    frames_rgb = np.ascontiguousarray(np.stack(
        [_cli_scene(i) for i in range(CLI_FRAMES)])[..., ::-1])
    shape = (FRAME_H, FRAME_W)
    step_cfg = FrameStepConfig(score_threshold=FRCNN_THRESHOLD)
    cpu = torch.device("cpu")
    modes = ("argmax", "per_class")
    names = _frcnn_labels(cfg.num_classes)

    # 1. float32, card against the CPU port, two resized walker frames
    t1 = time.perf_counter()
    card = FasterRCNNDetector(state_dict=sd, config=cfg, device=dev,
                              compute_dtype=torch.float32,
                              score_threshold=FRCNN_THRESHOLD)
    card.labels = dict(enumerate(names))
    fs = _framestep(dev, shape, step_cfg=step_cfg, detector=card)
    inputs = fs.detector_input(torch.from_numpy(
        frames_rgb[CLI_START + 6::12][:2]).to(dev)).cpu()
    del fs
    host = FasterRCNNDetector(state_dict=sd, config=cfg, device=cpu,
                              compute_dtype=torch.float32,
                              score_threshold=FRCNN_THRESHOLD)
    problems, lines = _frcnn_card_vs_cpu(card, host, inputs, modes)
    del host
    for line in lines:
        log(f"[frcnn] float32 card vs CPU, {len(inputs)} resized 720p "
            f"frames: {line}")
    log(f"[frcnn] float32 card vs CPU: {len(problems)} problems "
        f"({time.perf_counter() - t1:.1f} s)")
    if problems:
        raise SystemExit(f"frcnn: float32 card vs CPU: {problems[:6]}")

    # 2. the TF-free name-map conversion at full width
    t1 = time.perf_counter()
    flat = wm.faster_rcnn_to_flax(card.net)
    tensors = _tfod_named(flat, cfg)
    conv, rep = cvm.convert_faster_rcnn_tfod(tensors,
                                             input_size=cfg.input_size)
    if rep["missing"] or rep["unused"] or \
            rep["config"].block_units != (3, 4, 23, 3):
        raise SystemExit(f"frcnn: conversion report {rep}")
    conv_det = FasterRCNNDetector(state_dict=wm.faster_rcnn_from_flax(conv),
                                  config=rep["config"], device=dev,
                                  compute_dtype=torch.float32,
                                  score_threshold=FRCNN_THRESHOLD)
    with torch.inference_mode():
        got = conv_det.net(inputs.to(dev))
        want = card.net(inputs.to(dev))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"[frcnn] TF-OD names (resnet_v1_101, {len(tensors)} tensors) -> "
        f"convert_faster_rcnn_tfod: config {rep['config'].block_units}, "
        f"{rep['assigned']} assigned; card detections identical to the "
        f"donor's: {same} ({time.perf_counter() - t1:.1f} s)")
    if not same:
        raise SystemExit("frcnn: the converted detector differs on the card")
    del card, conv_det, conv, tensors

    # 3. bf16 FrameStep: step over 16 frames, run_chunk over 8
    det = FasterRCNNDetector(state_dict=sd, config=cfg, device=dev,
                             score_threshold=FRCNN_THRESHOLD)
    det.labels = dict(enumerate(names))
    fs = _framestep(dev, shape, step_cfg=step_cfg, detector=det)
    seq = frames_rgb[CLI_START:CLI_START + 16]
    chunk = frames_rgb[CLI_START + 16:CLI_START + 24]
    state = fs.init_state()
    for f in frames_rgb[CLI_START - 2:CLI_START]:          # warm-up
        state, out, snap, _ = fs.step(state, f)
    fs.run_chunk(fs.init_state(), chunk)
    _sync(dev)
    lsap.launches = 0
    devmod.host_syncs = 0
    dets = []
    t1 = time.perf_counter()
    for f in seq:
        state, out, snap, _ = fs.step(state, f)
        dets.append(snap.valid.sum())
    _sync(dev)
    step_ms = (time.perf_counter() - t1) / len(seq) * 1e3
    step_syncs = devmod.host_syncs / len(seq)
    step_launches = lsap.launches
    _check_outputs(out, snap, 64, 32)
    devmod.host_syncs = 0
    t1 = time.perf_counter()
    state, couts, csnaps = fs.run_chunk(state, chunk)
    _sync(dev)
    chunk_ms = (time.perf_counter() - t1) / len(chunk) * 1e3
    chunk_syncs = devmod.host_syncs / len(chunk)
    _check_outputs(couts, csnaps, 64, 32)
    launches = lsap.launches
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    log(f"[frcnn] bf16 FrameStep 720p (input {det.width}x{det.height}, "
        f"score threshold {FRCNN_THRESHOLD}, bgsub off): step "
        f"{step_ms:.3f} ms/frame, {step_syncs:.2f} host syncs/frame, "
        f"detections/frame {[int(d) for d in dets]}; run_chunk(8) "
        f"{chunk_ms:.3f} ms/frame, {chunk_syncs:.2f} host syncs/frame; "
        f"LSAP launches {step_launches} in step, "
        f"{launches - step_launches} in run_chunk; peak device memory "
        f"{peak:.2f} GiB")
    if launches <= 0:
        raise SystemExit("frcnn: the LSAP kernel never launched")
    profile_step(fs, seq[:8], dev, tag="frcnn", state=state,
                 stages=FRCNN_STAGES)
    del fs, det, state, couts, csnaps

    # 4. the CLI on a .npz of the weights and a .pbtxt, --chunk-size 8
    lsap.launches = 0
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        npz = f"{tmp}/faster_rcnn_resnet101.npz"
        np.savez(npz, **flat)
        _write_pbtxt(f"{tmp}/map.pbtxt", names)
        pipe, timing, n, bad = _run_cli(
            ["--input", "synthetic://walkers", "--disable-graphics",
             "--streaming", "0", "--control-port", "0",
             "--model", npz, "--labels", f"{tmp}/map.pbtxt",
             "--wanted-labels", ",".join(names), "--device", dev.type,
             "--score-threshold", str(FRCNN_THRESHOLD),
             "--chunk-size", "8", "--log", f"{tmp}/frcnn.log"], CLI_FRAMES)
    cli_launches = lsap.launches
    det = pipe.framestep.detector
    skip = 8
    counters = {k: v for k, v in
                pipe.counting.counters_payload().items() if v}
    log(f"[frcnn] CLI 720p --model faster_rcnn_resnet101.npz --labels "
        f"map.pbtxt --chunk-size 8 ({det.compute_dtype}, bgsub on, labels "
        f"{det.labels[0]!r}..{det.labels[cfg.num_classes - 1]!r}): {n} "
        f"frames in {time.perf_counter() - t1:.1f} s, objd "
        f"{float(np.mean(timing['objd'][skip:])):.3f} ms/frame, e2e "
        f"{float(np.mean(timing['e2e'][skip:])):.3f} ms/frame (mean over "
        f"frames {skip + 1}-{n}), {cli_launches} LSAP launches, {bad} "
        f"frames with non-finite outputs; nonzero counters {counters}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    if n != CLI_FRAMES or bad or not isinstance(det.net, FasterRCNNNet):
        raise SystemExit(f"frcnn: CLI saw {n} frames, {bad} non-finite")
    del pipe, det
    return launches + cli_launches


# ---------------------------------------------------------------- phase 10

# The tflite phase's artifacts: there is no tensorflow on the card's
# machine, so the phase writes its own .tflite files, with numpy alone.

def _flex_map(opts):
    """A flexbuffer whose root is the map `opts` of int, float and bool
    scalars (what TFLite_Detection_PostProcess's options are): keys sorted
    bytewise as NUL-terminated strings, a typed vector of key offsets, the
    map's prefix (keys offset, keys byte width, length), the values at one
    byte width (4, or 8 when a value needs it) and their packed types, then
    the root offset, the root's packed type and its byte width."""
    import struct
    keys = sorted(opts, key=lambda k: k.encode())
    fit4 = all(isinstance(v, bool) or (isinstance(v, int)
                                       and -2 ** 31 <= v < 2 ** 31)
               or (isinstance(v, float) and float(np.float32(v)) == v)
               for v in opts.values())
    w = 4 if fit4 else 8
    code = {4: 2, 8: 3}[w]
    out = bytearray()
    key_pos = []
    for k in keys:
        key_pos.append(len(out))
        out += k.encode() + b"\0"

    def align(n):
        out.extend(b"\0" * (-len(out) % n))

    def uint(v):
        out.extend(struct.pack({4: "<I", 8: "<Q"}[w], v))
    align(w)
    uint(len(keys))                        # keys vector length
    keys_vec = len(out)
    for kp in key_pos:
        uint(len(out) - kp)
    uint(len(out) - keys_vec)              # map prefix: keys offset
    uint(w)                                # keys byte width
    uint(len(keys))                        # length
    map_pos = len(out)
    types = []
    for k in keys:
        v = opts[k]
        if isinstance(v, bool):
            uint(int(v))
            types.append(26 << 2 | code)
        elif isinstance(v, int):
            out.extend(struct.pack({4: "<i", 8: "<q"}[w], v))
            types.append(1 << 2 | code)
        elif isinstance(v, float):
            out.extend(struct.pack({4: "<f", 8: "<d"}[w], v))
            types.append(3 << 2 | code)
        else:
            raise TypeError(f"flexbuffer option {k}={v!r}")
    out.extend(bytes(types))
    align(w)
    uint(len(out) - map_pos)               # root: offset back to the map
    out.extend(bytes([9 << 2 | code, w]))  # root packed type (map), width
    return bytes(out)


def _fb_serialize(root, ident=b"TFL3"):
    """Serialize a flatbuffer from nested specs, front to back: a table is
    a list of (slot, kind, value) with kind one of 'u8' 'i8' 'i32' 'u32'
    (inline scalars), 'str' (bytes), 'i32v' 'f32v' 'i64v' (numpy vectors),
    'u8v' (bytes, 16-byte aligned), 'table' and 'tables'. Each table's
    vtable is written just before it, and everything a table refers to
    after it, so that every uoffset is positive."""
    import struct
    buf = bytearray(8)
    inline = {"u8": (1, "<B"), "i8": (1, "<b"), "i32": (4, "<i"),
              "u32": (4, "<I")}

    def pad_to(n, extra=0):
        buf.extend(b"\0" * (-(len(buf) + extra) % n))

    def table(fields):
        nslots = max(f[0] for f in fields) + 1 if fields else 0
        # 4-byte fields (scalars and uoffsets) first, then 1-byte ones
        order = sorted(fields, key=lambda f: -inline.get(f[1], (4,))[0])
        offs, size = {}, 4
        for slot, kind, _ in order:
            offs[slot] = size
            size += inline.get(kind, (4,))[0]
        pad_to(2)
        vt = len(buf)
        buf.extend(struct.pack("<HH", 4 + 2 * nslots, size))
        buf.extend(struct.pack(f"<{nslots}H", *(offs.get(i, 0)
                                                for i in range(nslots))))
        pad_to(4)
        tp = len(buf)
        buf.extend(b"\0" * size)
        struct.pack_into("<i", buf, tp, tp - vt)
        children = []
        for slot, kind, value in order:
            at = tp + offs[slot]
            if kind in inline:
                struct.pack_into(inline[kind][1], buf, at, value)
            else:
                children.append((at, kind, value))
        for at, kind, value in children:
            struct.pack_into("<I", buf, at, child(kind, value) - at)
        return tp

    def child(kind, value):
        if kind == "table":
            return table(value)
        if kind == "str":
            pad_to(4)
            p = len(buf)
            buf.extend(struct.pack("<I", len(value)) + value + b"\0")
            return p
        if kind == "tables":
            pad_to(4)
            p = len(buf)
            buf.extend(struct.pack("<I", len(value)) + b"\0" * 4 * len(value))
            for i, t in enumerate(value):
                at = p + 4 + 4 * i
                struct.pack_into("<I", buf, at, table(t) - at)
            return p
        data = (bytes(value) if kind == "u8v" else np.ascontiguousarray(
            value, {"i32v": "<i4", "f32v": "<f4", "i64v": "<i8"}[kind]))
        n = len(data) if kind == "u8v" else data.size
        pad_to(4)
        pad_to(16 if kind == "u8v" else
               max(4, data.dtype.itemsize), extra=4)
        p = len(buf)
        buf.extend(struct.pack("<I", n))
        buf.extend(data if kind == "u8v" else data.tobytes())
        return p

    rp = table(root)
    struct.pack_into("<I", buf, 0, rp)
    buf[4:8] = ident
    return bytes(buf)


_TFL_CONV = {"conv": 3, "dw": 4, "dense": 9}
_TFL_ADD, _TFL_MUL, _TFL_CONCAT, _TFL_CUSTOM = 0, 18, 2, 32


def write_tflite(slots, ops, graph, order=None, postprocess=None,
                 input_shape=(1, 1, 1, 3)):
    """A .tflite flatbuffer (bytes) holding the op stream that
    models/convert.py `fold_slots_to_ops` emits for a donor: each conv,
    depthwise conv and dense layer as CONV_2D / DEPTHWISE_CONV_2D /
    FULLY_CONNECTED with its kernel in TFLite layout and its batch norm
    folded (float32 constants), each standalone batch norm as a constant
    MUL and a constant ADD. `graph` is `trace_graph`'s (conv slots, ups,
    downs): each weight op reads the output of its immediate weight-bearing
    ancestors (through a CONCATENATION, a neutral op, when it has several)
    or the graph input, so the conv dataflow graph is the donor's; the
    MUL / ADD pairs read the graph input and feed nothing, off that graph.
    `order` is the slot order of emission (default the slots' own;
    TF's converter emits e.g. the SSD's heads in reverse level order).
    `postprocess` (anchors, box head slots, class head slots, options)
    appends a TFLite_Detection_PostProcess custom op on the
    concatenated heads, with the anchor table as a constant and the
    options as a flexbuffer map."""
    conv_slots, ups, _ = graph
    node_of = {si: n for n, si in enumerate(conv_slots)}
    op_of, k = {}, 0
    for si, slot in enumerate(slots):
        op_of[si] = k
        k += 2 if slot.kind == "bn" else 1
    tensors, buffers, operators, opcodes = [], [[(0, "u8v", b"")]], [], []

    def buffer(arr):
        buffers.append([(0, "u8v", np.ascontiguousarray(
            arr, np.float32).tobytes())])
        return len(buffers) - 1

    def tensor(name, arr=None, shape=None):
        fields = [(1, "i8", 0), (3, "str", name.encode())]
        if arr is not None:
            fields += [(0, "i32v", np.asarray(arr.shape, np.int32)),
                       (2, "u32", buffer(arr))]
        elif shape is not None:
            fields.append((0, "i32v", np.asarray(shape, np.int32)))
        tensors.append(fields)
        return len(tensors) - 1

    def opcode(code, custom=None):
        key = (code, custom)
        if key not in opcodes:
            opcodes.append(key)
        return opcodes.index(key)

    def operator(code, ins, outs, custom=None, options=None):
        fields = [(0, "u32", opcode(code, custom)),
                  (1, "i32v", np.asarray(ins, np.int32)),
                  (2, "i32v", np.asarray(outs, np.int32))]
        if options is not None:
            fields += [(5, "u8v", options), (6, "i8", 0)]
        operators.append(fields)

    def join(srcs, name):
        if len(srcs) == 1:
            return srcs[0]
        t = tensor(name)
        operator(_TFL_CONCAT, srcs, [t])
        return t

    t_in = tensor("input", shape=input_shape)
    out_t = {n: tensor(f"{'/'.join(slots[si].path)}/out")
             for n, si in enumerate(conv_slots)}
    for si in (order if order is not None else range(len(slots))):
        slot = slots[si]
        name = "/".join(slot.path)
        if slot.kind == "bn":
            mul, add = ops[op_of[si]], ops[op_of[si] + 1]
            t_mul = tensor(f"{name}/mul")
            operator(_TFL_MUL, [t_in, tensor(f"{name}/mul_c", mul.kernel)],
                     [t_mul])
            operator(_TFL_ADD, [t_mul, tensor(f"{name}/add_c", add.kernel)],
                     [tensor(f"{name}/add")])
            continue
        n = node_of[si]
        op = ops[op_of[si]]
        src = join([out_t[u] for u in ups[n]], f"{name}/in") \
            if ups[n] else t_in
        ins = [src, tensor(f"{name}/kernel", op.kernel)]
        if op.bias is not None:
            ins.append(tensor(f"{name}/bias", op.bias))
        operator(_TFL_CONV[slot.kind], ins, [out_t[n]])
    if postprocess is not None:
        anchors, box_slots, cls_slots, options = postprocess
        boxes = join([out_t[node_of[si]] for si in box_slots], "boxes")
        scores = join([out_t[node_of[si]] for si in cls_slots], "scores")
        outs = [tensor("TFLite_Detection_PostProcess" + s)
                for s in ("", ":1", ":2", ":3")]
        operator(_TFL_CUSTOM,
                 [boxes, scores, tensor("anchors",
                                        np.asarray(anchors, np.float32))],
                 outs, custom=b"TFLite_Detection_PostProcess",
                 options=_flex_map(options))
        outputs = outs
    else:
        consumed = {u for n in range(len(conv_slots)) for u in ups[n]}
        outputs = [out_t[n] for n in range(len(conv_slots))
                   if n not in consumed]
    codes = [[(0, "i8", min(code, 127)), (2, "i32", 1), (3, "i32", code)]
             + ([(1, "str", custom)] if custom else [])
             for code, custom in opcodes]
    subgraph = [(0, "tables", tensors),
                (1, "i32v", np.asarray([t_in], np.int32)),
                (2, "i32v", np.asarray(outputs, np.int32)),
                (3, "tables", operators)]
    return _fb_serialize([(0, "u32", 3), (1, "tables", codes),
                          (2, "tables", [subgraph]),
                          (4, "tables", buffers)])


TFLITE_THRESHOLD = 0.3     # the postprocess op's and the CLI's threshold
TFLITE_MAX_DETECTIONS = 10  # below max_outputs (32): the cap bites


def _ssd_head_order(slots):
    """Slot emission order with the SSD's box / class heads last, in
    reverse level order (TF's converter's), and the heads' slot indices
    by level."""
    by_path = {"/".join(s.path): i for i, s in enumerate(slots)}
    box = [by_path[f"box_head{lv}"] for lv in range(6)]
    cls = [by_path[f"cls_head{lv}"] for lv in range(6)]
    heads = set(box + cls)
    order = [i for i in range(len(slots)) if i not in heads]
    for lv in reversed(range(6)):
        order += [box[lv], cls[lv]]
    return order, box, cls


def written_tflite(net, example_shape, postprocess_options=None):
    """`net`'s weights (a port SSDMobileNetV1 or MarsNet on the CPU) as a
    .tflite flatbuffer written by `write_tflite`: the op stream of
    `fold_slots_to_ops` wired by `trace_graph`'s conv graph; for the SSD
    the heads in reverse level order and, with `postprocess_options`, a
    TFLite_Detection_PostProcess op carrying the generated anchors."""
    import torch
    from deepdish_tpu_torch.models import convert as cvm
    from deepdish_tpu_torch.models import weights as wm
    with torch.device("meta"):
        template = type(net)()
    _, slots, graph = cvm.trace_graph(template, example_shape)
    ops = cvm.fold_slots_to_ops(wm.to_flax(net), slots)
    order, pp = None, None
    if type(net).__name__ == "SSDMobileNetV1":
        from deepdish_tpu_torch.models.ssd_mobilenet import generate_anchors
        order, box, cls = _ssd_head_order(slots)
        if postprocess_options is not None:
            pp = (generate_anchors(), box, cls, postprocess_options)
    return write_tflite(slots, ops, graph, order=order, postprocess=pp,
                        input_shape=example_shape)


def _ssd_pp_options():
    return dict(max_detections=TFLITE_MAX_DETECTIONS,
                max_classes_per_detection=1, detections_per_class=100,
                use_regular_nms=False,
                nms_score_threshold=TFLITE_THRESHOLD,
                nms_iou_threshold=0.6, num_classes=90, y_scale=10.0,
                x_scale=10.0, h_scale=5.0, w_scale=5.0)


def phase_tflite(dev):
    """The structural weight path on written artifacts: a full-width
    SSD-MobileNetV1 (300, 91 classes) with a TFLite_Detection_PostProcess
    op and a MARS encoder, each a seeded donor with batch norms calibrated
    on the walker scene, written as .tflite by `write_tflite` (numpy
    only), converted by the port (load_ssd_mobilenet_tflite, load_mars):
    the report complete with the anchors verified; float32 detections of
    the converted SSD on the card against the donor's with the op's
    configuration (`_compare_detections`, scores and boxes within 1e-4 of
    their range); MARS features within 1e-4; then the CLI on both files at
    --chunk-size 8 in bf16 (every frame finite, LSAP launches > 0).
    Returns the LSAP launches of the CLI run."""
    import tempfile

    import torch
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import COCO_LABELS, create_detector
    from deepdish_tpu_torch.models import convert as cvm
    from deepdish_tpu_torch.models import weights as wm
    from deepdish_tpu_torch.models.encoders import make_mars_encoder
    from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
    from deepdish_tpu_torch.models.registry import _pp_det_kw
    from deepdish_tpu_torch.models.ssd_mobilenet import (INPUT_SIZE,
                                                         SSDMobileNetDetector,
                                                         SSDMobileNetV1)
    t_phase = time.perf_counter()
    frames_rgb = np.ascontiguousarray(np.stack(
        [_cli_scene(i) for i in range(CLI_FRAMES)])[..., ::-1])
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the artifacts, written from calibrated donors
        t0 = time.perf_counter()
        ssd = SSDMobileNetV1()
        _calibrated_init(ssd, torch.Generator().manual_seed(SEED),
                         _calibration_images(INPUT_SIZE, INPUT_SIZE))
        mars = MarsNet()
        _calibrated_init(mars, torch.Generator().manual_seed(SEED + 1),
                         _calibration_images(*INPUT_SHAPE[:2]))
        ssd_path = f"{tmp}/ssd_mobilenet_v1_coco_pp.tflite"
        mars_path = f"{tmp}/mars-small128.tflite"
        for path, net, shape, opts in (
                (ssd_path, ssd, (1, INPUT_SIZE, INPUT_SIZE, 3),
                 _ssd_pp_options()),
                (mars_path, mars, (1,) + INPUT_SHAPE, None)):
            with open(path, "wb") as f:
                f.write(written_tflite(net, shape, opts))
        sizes = {p: len(open(p, "rb").read()) / 2 ** 20
                 for p in (ssd_path, mars_path)}
        log(f"[tflite] donors calibrated and written in "
            f"{time.perf_counter() - t0:.1f} s: SSD {sizes[ssd_path]:.1f} "
            f"MiB, MARS {sizes[mars_path]:.1f} MiB")

        # 2. the conversions
        t0 = time.perf_counter()
        flat, rep = cvm.load_ssd_mobilenet_tflite(ssd_path)
        ssd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mflat, mrep = cvm.load_mars(mars_path)
        mars_s = time.perf_counter() - t0
        log(f"[tflite] load_ssd_mobilenet_tflite {ssd_s:.2f} s: assigned "
            f"{rep['assigned']} of {rep['total']}, missing "
            f"{len(rep['missing'])}, unused ops {len(rep['unused_ops'])}, "
            f"anchors_verified {rep.get('anchors_verified')}; load_mars "
            f"(.tflite) {mars_s:.2f} s: assigned {mrep['assigned']} of "
            f"{mrep['total']}, missing {len(mrep['missing'])}, unused ops "
            f"{len(mrep['unused_ops'])}")
        if rep["assigned"] != rep["total"] or rep["missing"] or \
                rep["unused_ops"] or not rep.get("anchors_verified") or \
                mrep["assigned"] != mrep["total"] or mrep["missing"] or \
                mrep["unused_ops"]:
            raise SystemExit(f"tflite: conversion reports {rep} {mrep}")

        # 3. float32 detections on the card: converted against the donor
        pp = rep["postprocess"]
        conv_det = create_detector(ssd_path, device=dev,
                                   compute_dtype=torch.float32,
                                   score_threshold=TFLITE_THRESHOLD)
        donor_det = SSDMobileNetDetector(
            state_dict=ssd.state_dict(), device=dev,
            compute_dtype=torch.float32,
            **_pp_det_kw(pp, TFLITE_THRESHOLD))
        fs = _framestep(dev, (FRAME_H, FRAME_W), detector=conv_det)
        inputs = fs.detector_input(torch.from_numpy(
            frames_rgb[CLI_START + 6::12][:2]).to(dev))
        del fs
        outs = []
        for det in (conv_det, donor_det):
            with torch.inference_mode():
                raw = det.detect(inputs, float(FRAME_W), float(FRAME_H))
            outs.append([x.cpu().numpy() for x in raw])
        report, serr, berr = [], 0.0, 0.0
        for i in range(len(inputs)):
            p, se, be = _compare_detections(*([x[i] for x in o]
                                              for o in outs))
            report += [f"frame {i}: {m}" for m in p]
            serr, berr = max(serr, se), max(berr, be)
        n_valid = [int(v.sum()) for v in outs[1][3]]
        log(f"[tflite] float32 SSD detect on the card, converted vs donor "
            f"(op anchors, scales {pp.scales}, max_detections "
            f"{pp.max_detections}, threshold {conv_det.score_threshold}) on "
            f"{len(inputs)} resized 720p frames, valid {n_valid}: "
            f"{len(report)} problems, max |score| error {serr:.3e}, max box "
            f"error {berr:.3e} of the largest box coordinate")
        if report or serr > 1e-4 or berr > 1e-4 or min(n_valid) <= 0 or \
                max(n_valid) > TFLITE_MAX_DETECTIONS:
            raise SystemExit(f"tflite: SSD converted vs donor: {report[:6]}")
        del conv_det, donor_det, inputs

        # 4. MARS features on the card: converted against the donor
        encs = [make_mars_encoder(state_dict=sd, device=dev,
                                  compute_dtype=torch.float32)
                for sd in (wm.mars_from_flax(mflat), mars.state_dict())]
        patches = torch.cat([
            _calibration_images(*INPUT_SHAPE[:2]),
            torch.from_numpy(np.random.RandomState(SEED + 40).uniform(
                0, 255, (12,) + INPUT_SHAPE).astype(np.float32))]).to(dev)
        with torch.inference_mode():
            got, want = (e.apply(patches) for e in encs)
        merr = float((got - want).abs().max())
        log(f"[tflite] float32 MARS on the card, converted vs donor, "
            f"{len(patches)} patches: max |feature| error {merr:.3e}")
        if not merr <= 1e-4:
            raise SystemExit(f"tflite: MARS features differ by {merr}")
        del encs, patches

        # 5. the CLI on both written files, --chunk-size 8, bf16
        lsap.launches = 0
        t0 = time.perf_counter()
        pipe, timing, n, bad = _run_cli(
            ["--input", "synthetic://walkers", "--disable-graphics",
             "--streaming", "0", "--control-port", "0",
             "--model", ssd_path, "--encoder-model", mars_path,
             "--wanted-labels", ",".join(COCO_LABELS),
             "--device", dev.type,
             "--score-threshold", str(TFLITE_THRESHOLD),
             "--chunk-size", "8", "--log", f"{tmp}/tflite.log"], CLI_FRAMES)
    launches = lsap.launches
    det = pipe.framestep.detector
    skip = 8
    counters = {k: v for k, v in
                pipe.counting.counters_payload().items() if v}
    log(f"[tflite] CLI 720p --model ssd_mobilenet_v1_coco_pp.tflite "
        f"--encoder-model mars-small128.tflite --chunk-size 8 "
        f"({det.compute_dtype}, bgsub on, detections_cap "
        f"{det.detections_cap}): {n} frames in "
        f"{time.perf_counter() - t0:.1f} s (conversions included), objd "
        f"{float(np.mean(timing['objd'][skip:])):.3f} ms/frame, e2e "
        f"{float(np.mean(timing['e2e'][skip:])):.3f} ms/frame (mean over "
        f"frames {skip + 1}-{n}), {launches} LSAP launches, {bad} frames "
        f"with non-finite outputs; nonzero counters {counters}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(f"[tflite] card: {smi.stdout.strip() or 'nvidia-smi: no output'}")
    if n != CLI_FRAMES or bad or launches <= 0 or \
            det.detections_cap != TFLITE_MAX_DETECTIONS:
        raise SystemExit(f"tflite: CLI saw {n} frames, {bad} non-finite, "
                         f"{launches} LSAP launches")
    del pipe, det
    return launches


# ---------------------------------------------------------------- phase 11

def phase_probe(dev):
    """The ported probe at full width through its entry point; returns the
    dsconv launches by stride, counted from 0 over this run only."""
    import torch
    from deepdish_tpu_torch.kernels import dsconv
    from deepdish_tpu_torch.tools import probe_dsconv

    dsconv.launches = 0
    dsconv.stride_launches.update({1: 0, 2: 0})
    t0 = time.perf_counter()
    rows = probe_dsconv.main(["--rounds", "2", "--reps", "4"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dsconv.launches
    by_stride = dict(dsconv.stride_launches)
    log(f"[probe] {len(rows)} stages at batch 32, 6 layers, in {seconds:.1f} "
        f"s; dsconv launches {launches} (stride 1: {by_stride[1]}, stride 2: "
        f"{by_stride[2]})")
    if len(rows) != len(probe_dsconv.STAGES) or \
            not all(np.isfinite(r["maxdiff"]) for r in rows):
        raise SystemExit(f"probe: expected {len(probe_dsconv.STAGES)} "
                         f"stages with finite outputs, got {rows}")
    if launches <= 0 or min(by_stride.values()) <= 0:
        raise SystemExit(f"probe: the dsconv kernel did not launch at both "
                         f"strides ({by_stride})")
    return by_stride


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

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_start:.1f} s so far)")
        return result

    timed("build", phase_build)
    entry = timed("kernel", phase_kernel, dev)
    ds_entries = timed("dsconv", phase_dsconv, dev)
    timed("tracker", phase_tracker, dev)
    timed("reference", phase_reference, dev)
    entry["launches"], _ = timed("slice", phase_slice, dev)
    timed("cli", phase_cli, dev)
    # the LSAP launches of the main path: the slice, the families, CVAT,
    # Faster R-CNN and the tflite phase's CLI
    entry["launches"] += timed("families", phase_families, dev)
    entry["launches"] += timed("cvat", phase_cvat, dev)
    entry["launches"] += timed("frcnn", phase_frcnn, dev)
    entry["launches"] += timed("tflite", phase_tflite, dev)
    by_stride = timed("probe", phase_probe, dev)
    for e, s in zip(ds_entries, (1, 2)):
        e["launches"] = by_stride[s]
    log(json.dumps({"kernels": [entry] + ds_entries}))
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
