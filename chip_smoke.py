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
  5. reference the slice on a small input (96x128, 6 frames) in float32 on
             the card and on the CPU with the same weights, order-free per
             frame (detections, track ids, tracks), the networks' raw
             outputs within 1e-4 of their range;
  6. slice   FrameStep at 720p with random-init SSD-MobileNetV1 and MARS:
             `step` over 16 frames, `run_chunk` over 8; the LSAP launch
             count is reset before and read after, and must be > 0;
  7. cli     the port's CLI and what it adds under the frame step, at 720p
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
             float32 on the card and on the CPU at chunk 1 and 8 over the
             scene's frames CLI_SHORT_FIRST on (CLI_SHORT_FRAMES: the
             walkers from their start to past their crossing), whose
             counters must agree at each chunk size and not all be 0; and
             `--model scripted:bright` on the card (LSAP launches, reset
             before and read after, > 0) and on the CPU over the same
             frames, whose counters must both equal the crossings the
             scene implies;
  8. families YOLOv5s (320), YOLOv3 (416) and EfficientDet-Lite0 (320) at
             full width, seeded random weights with calibrated batch norms
             (`_family_init`; FAMILY_THRESHOLD): float32 detector outputs
             on the card against the CPU port on two resized (YOLOv3:
             letterboxed) 720p frames (integers exact, order-free only
             among scores tied to 1e-5); FrameStep `step` over 16 frames
             and `run_chunk` over 8 in bf16 (ms/frame, host syncs/frame,
             LSAP launches > 0); the CLI at --chunk-size 8 (every frame
             finite, objd and e2e);
  9. cvat    CVAT split mode through the CLI: the walker scene as a JPEG
             sequence with one annotated track, --input-cvat-dir and
             --output-cvat-dir; float32 with FrameStep.detect_only replaced
             by the bright-block script on the card and on the CPU (the
             two annotations.xml byte-identical, LSAP launches > 0), then
             the random SSD in bf16 on the card (LSAP launches > 0);
 10. frcnn   Faster R-CNN at full width (FasterRCNNConfig(): ResNet-101
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
 11. tflite  the structural weight path on artifacts the script writes
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
 12. quantized  the quantized paths at full width, on full-integer
             .tflite files the script writes itself (`QuantGraph`, numpy
             only, quantized on the walker scene): SSD-MobileNetV1 at 300
             with LOGISTIC and the postprocess op (`quant_ssd_donor`), MARS
             at 128x64 with int8 ELU, MAX_POOL_2D and L2_NORMALIZATION, and
             one graph per op of the YOLOv5 / EfficientDet files; every
             tensor of the integer executor on the card ("mxu":
             torch._int_mm, "portable": float64, and for the SSD "xconv")
             equal to the CPU executor's on 8 inputs (DEQUANTIZE bit-equal,
             SOFTMAX within 5e-7); the quantized SSD's detections card vs
             CPU; the w8a8 SSD (300) and MARS (128x64) int32 accumulators on
             the card equal to the CPU's on the same int8 inputs, batch 8;
             the integer contractions' device time a frame (profiler); the
             CLI at --chunk-size 8 with --quantized-inference on the two
             files and with --detector-int8 --encoder-model mars_int8 (bf16:
             objd, e2e, host syncs a frame, LSAP launches > 0), and each in
             float32 on the card and on the CPU over phase 7's float32
             frames, whose counters must agree and not all be 0;
 13. parallel the parallel engines and the last tools: MultiStreamEngine
             at bench.py's config 5 (16 streams of the walker scene at 720p,
             each rolled 48 px further, step_chunk at chunk 8, calibrated
             random SSD 300 + MARS in bf16, T = 64, D = 32, G = 64, labels
             person and car, encode capacity 8, bgsub off): aggregate and
             per-stream frames/s over 5 timed calls (the median, min and
             max of tools.bench.bench_streams), host syncs a frame, LSAP
             launches (> 0), one call under torch.profiler (stage split,
             idle share, top kernels); the same timing with every COCO
             label wanted, which loads the trackers; in float32 with every
             COCO label:
             step_chunk at S = 4, F = 8 against each stream's run_chunk,
             step against step_chunk(1), step_chunk_yuv against step_chunk
             on the converted frames, S = 2, F = 4 card against CPU, the
             temporal engine on [cuda] * 2 and the grid engine on a 2x2
             mesh of the card against run_chunk (detections order-free
             among scores tied to 1e-5, scores within 1e-4, boxes and
             matched boxes within 1 px, track ids and states exact), both
             engines' bgsub ValueError; then tools/multistream_demo (3
             streams, --max-frames 8, through `open_loader`) and
             tools/mot_features (card vs CPU features within 1e-4);
 14. probe   the ported dsconv probe (deepdish_tpu_torch.tools.probe_dsconv)
             at full width: batch 32, 6 layers, all 9 stages, 2 rounds of 4;
             the dsconv launch counts are reset before and read after, and
             both strides must have launched;
 15. bench   the port's measuring tools in process, at full width (720p,
             phase 13's calibrated random SSD 300 + MARS (one calibration
             serves both phases) in bf16, bench.py's
             FrameStep: T = 64, D = 32, G = 64, labels person and car,
             encode capacity 8), through their `main` with the FrameStep
             given: deepdish_tpu_torch.tools.bench --latency (200 steps
             resident and e2e), the chunked mode on synthetic I420 frames
             (chunk 32, 160 frames, depth 2, 5 rounds of 2 resident calls)
             and on an mp4 where the native frame loader builds (else a
             line says what is missing), --streams 16 (config 5, 5 rounds
             of one call) and, with the loader, --streams 16 --e2e; then
             tools.profile_components (chunk 32, 5 reps): each prints its
             JSON line; every number finite (timings positive), LSAP
             launches > 0 in every bench mode;
 16. tools   the last measuring and validation tools through their `main`:
             tools.flops_report for SSD + MARS, YOLOv5s, YOLOv3,
             EfficientDet-Lite0, Faster R-CNN and the full-integer SSD
             (--quantized) at chunk 32, encode capacity 8: GFLOP a frame
             by stage, the card's count at 32 frames equal to 32 times the
             CPU's at 1, stage by stage; SSD + MARS's TFLOP/s and MFU at
             phase 15's chunked `_window` rate; fused_dsconv's count on
             the card (the kernel's reported work) equal to the plain
             version's on the CPU; tools.profile_micro's three groups at
             the JAX tool's shapes (4 reps; host ms, device ms, host syncs
             a call; the LSAP kernel's 64x64 assignment equal to the plain
             version's); tools.coldstart_probe's --fresh and --cold legs
             in fresh processes (720p, chunk 32; the cold leg builds the
             LSAP library with nvcc into an empty directory; equal track
             ids); tools.zoo_validate --device cuda and --device cpu on a
             float SSD with the postprocess op, a float MARS and their
             full-integer counterparts, written as phases 11 and 12 write
             them: exit 0, parse, anchors, convert and drive PASS
             (encoders: convert), integer, detect and embed SKIP without
             tensorflow, card steps == CPU steps (the drive step only
             where cv2 writes and reads back an mp4: else a line says so);
             none of its runs adds to the LSAP's launch count
             (flops_report replays the tracker to split its count);
 17. probes  the six last tools through their `main` at the JAX tools'
             shapes, PROBE_ROUNDS timed rounds each: tools.probe_int8
             (bf16 against int8 on a 4096^2 product and three convs; the
             int8 legs card == CPU exactly on a seeded input),
             tools.profile_mars_int8 (MARS at batch 1024 in bf16 and int8,
             impl dot and conv, their features bit-equal; the fused step at
             chunk 32, 720p, encode capacity 32 and 8, on phase 13's
             donors), tools.round4_ab_interleaved --mars-bisect
             --mars-cap32 --det-int8 --weights on phase 12's full-integer
             SSD file, tools.probe_grouped_conv (the packed layout per crop
             == the base conv within the reorder bound) and
             tools.profile_mars_width (Wide(32, 64, 128) == MarsNet):
             exit 0 (a rate above the H100's dense peak exits 1), every
             timing finite and positive, the fused legs' LSAP launches
             > 0; tools.decode_probe where the native frame loader loads
             (else a line names what OpenCV part is missing);
 18. report  the `kernels` JSON line (the LSAP's launches: phases 6, 8, 9,
             10, 11, 12, 13, 15 and 17), the card's name and power limit,
             and as the last line {"ok": true, "device": {...}}.

Each phase prints its seconds.
Exits non-zero, printing no result, when there is no card or the port is not
beside this file.
"""
from __future__ import annotations

import contextlib
import functools
import io
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


# ---------------------------------------------------------------- phase 6

def _framestep(dev, frame_shape, compute_dtype=None, step_cfg=None,
               detector=None, encoder=None):
    """A FrameStep at the CLI's default widths with random seeded weights:
    `detector`, or SSD-MobileNetV1, and `encoder`, or MARS."""
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
    enc = encoder or create_box_encoder(
        "mars", device=dev, compute_dtype=compute_dtype,
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
    """torch.profiler over plain `step` calls (`_profiled`)."""
    if state is None:
        state = fs.init_state()

    def run():
        nonlocal state
        for f in frames:
            state, _, _, _ = fs.step(state, f)
    _profiled(run, len(frames), dev, tag, "step", stages)


def _profiled(fn, n, dev, tag, what, stages=STAGES):
    """torch.profiler over fn(), which does n frames' work
    (`tools.profile_components.profiled`): per frame, each stage's host
    time and device time from the record_function ranges FrameStep places
    around its stages, and the device's busy share (CUDA kernel and copy
    time over wall time; the profiler's own cost is in the wall), logged
    with the top six kernels. Returns (host ms by stage, device ms by
    stage, idle share or None)."""
    from deepdish_tpu_torch.tools.profile_components import (profiled,
                                                             split_lines)
    r = profiled(fn, n, dev, stages, top=6)
    for line in split_lines(r, tag, what):
        log(line)
    return r["host_ms"], r["device_ms"], r["idle_share"]


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


# ---------------------------------------------------------------- phase 7

CLI_WALKERS = 6            # rows of bright blocks, alternating direction
CLI_START = 20             # frames of empty background before they walk
CLI_FRAMES = 56
# the card-vs-CPU CLI runs of phases 7 and 12 (float32, scripted): 4
# frames of background for MOG2, then the walkers until past their
# crossing (frame 39)
CLI_SHORT_FIRST = CLI_START - 4
CLI_SHORT_FRAMES = 32


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
    no cv2): read, get, set, release; frames first ... first + n_frames - 1
    of the scene."""

    def __init__(self, n_frames, first=0):
        self.n, self.i, self.first = n_frames, 0, first

    def read(self):
        if self.i >= self.n:
            return False, None
        self.i += 1
        return True, _cli_scene(self.first + self.i - 1)

    def get(self, prop):
        from deepdish_tpu_torch.pipeline import runtime
        return {runtime.CAP_PROP_FRAME_WIDTH: FRAME_W,
                runtime.CAP_PROP_FRAME_HEIGHT: FRAME_H,
                runtime.CAP_PROP_FPS: 15.0}.get(prop, 0)

    def set(self, prop, value):
        return True

    def release(self):
        pass


def _run_cli(argv, n_frames=None, first=0):
    """deepdish_tpu_torch.pipeline.main.amain, with n_frames of the scene
    from frame `first` through Pipeline._open_capture (None: the CLI opens
    its own input). Returns (pipeline, per-frame timing ms by label,
    frames seen by the frame step, non-finite frames)."""
    import asyncio

    from deepdish_tpu_torch.pipeline import main as cli
    from deepdish_tpu_torch.pipeline.elements import TimingInfo
    from deepdish_tpu_torch.pipeline.runtime import Pipeline
    seen = {"timing": {}, "frames": 0, "bad": 0}

    class SmokePipeline(Pipeline):
        def _open_capture(self, source):
            if n_frames is None:
                return super()._open_capture(source)
            return _SceneCapture(n_frames, first)

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
    the registry's classes and the encoder factories (the quantized ones
    included) while the block runs."""
    import torch
    from deepdish_tpu_torch.models import (encoders, mars_q, qgraph,
                                           registry, ssd_q)
    names = ("SSDMobileNetDetector", "YOLOv5Detector", "YOLOv3Detector",
             "EfficientDetLite0Detector")
    saved = [(registry, n, getattr(registry, n)) for n in names] + \
        [(encoders, "make_mars_encoder", encoders.make_mars_encoder),
         (qgraph, "QuantizedSSDDetector", qgraph.QuantizedSSDDetector),
         (qgraph, "make_quantized_mars_encoder",
          qgraph.make_quantized_mars_encoder),
         (ssd_q, "SSDMobileNetInt8Detector", ssd_q.SSDMobileNetInt8Detector),
         (mars_q, "make_mars_int8_encoder", mars_q.make_mars_int8_encoder)]
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
        # chunk 1 and 8, over the scene's frames CLI_SHORT_FIRST on: the
        # card must count what the CPU counts, and some counter must move
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
                                  ".log"], CLI_SHORT_FRAMES, CLI_SHORT_FIRST)
                f32[where, chunk_size] = {
                    k: v for k, v in
                    pipe.counting.counters_payload().items() if v}
                log(f"[cli] default CLI in float32 on {where}, --chunk-size "
                    f"{chunk_size}: {n} frames in "
                    f"{time.perf_counter() - t0:.1f} s, {lsap.launches} "
                    f"LSAP launches, {bad} non-finite; nonzero counters "
                    f"{f32[where, chunk_size]}")
                if n != CLI_SHORT_FRAMES or bad or \
                        not f32[where, chunk_size]:
                    raise SystemExit(f"cli: the float32 run saw {n} frames, "
                                     f"{bad} non-finite, counters "
                                     f"{f32[where, chunk_size]}")
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
                CLI_SHORT_FRAMES, CLI_SHORT_FIRST)
            counts[where] = pipe.counting.counters_payload()
            launches = lsap.launches
            log(f"[cli] scripted:bright on {where}: {n} frames in "
                f"{time.perf_counter() - t0:.1f} s, objd "
                f"{float(np.mean(timing['objd'][8:])):.3f} ms/frame, "
                f"{launches} LSAP launches; counters {counts[where]}")
            if where == "cuda" and launches <= 0:
                raise SystemExit("cli: the LSAP kernel never launched")
            if n != CLI_SHORT_FRAMES or bad:
                raise SystemExit(f"cli: scripted run saw {n} frames, "
                                 f"{bad} non-finite")
    expected = _cli_expected()
    log(f"[cli] expected crossings {expected}")
    if counts["cuda"] != expected or counts["cpu"] != expected:
        raise SystemExit(f"cli: counters {counts}, expected {expected}")


# ---------------------------------------------------------------- phase 8

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
    each card row of such a run is paired with the CPU row of its class
    whose box is nearest (anchors in one column have x1 within an ulp of
    each other, so no sort key orders both sides alike). Returns (problems,
    max score error, max box error relative to the largest box coordinate:
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
        free = list(range(a, b))
        for i in range(a, b):
            same = [j for j in free if pc[j] == cc[i]]
            if not same:
                problems.append(f"classes differ in slots {a}-{b}")
                break
            j = min(same, key=lambda j: float(np.abs(cb[i] - pb[j]).max()))
            free.remove(j)
            serr = max(serr, float(abs(cs[i] - ps[j])))
            berr = max(berr, float(np.abs(cb[i] - pb[j]).max()) / scale)
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


# ---------------------------------------------------------------- phase 9

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


# ---------------------------------------------------------------- phase 10

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


# ---------------------------------------------------------------- phase 11

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
              "f32": (4, "<f"),
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


# ---------------------------------------------------------------- phase 12

# The quantized phase's artifacts: full-integer .tflite files written with
# numpy (no tensorflow on the card's machine). `QuantGraph` records an op
# stream in float, runs it on calibration inputs to take every tensor's
# range, then writes the post-training full-integer file the TF converter
# would: int8 activations (asymmetric, per tensor), int8 weights
# (symmetric; per output channel for CONV_2D and DEPTHWISE_CONV_2D, per
# tensor for FULLY_CONNECTED), int32 biases at scale in * w, constants of
# MUL / ADD / SUB as int8 tensors, and the builtin options of every op.

_Q_CODES = dict(add=0, avgpool=1, concat=2, conv=3, dw=4, dequantize=6,
                fc=9, l2norm=11, logistic=14, maxpool=17, mul=18,
                reshape=22, softmax=25, custom=32, pad=34, sub=41,
                slice=45, tile=69, resize_nn=97, elu=111, quantize=114)
# kind -> (BuiltinOptions union type, [(slot, flatbuffer kind, attr)])
_Q_OPTIONS = {
    "conv": (1, [(0, "i8", "padding"), (1, "i32", "stride"),
                 (2, "i32", "stride"), (3, "i8", "act")]),
    "dw": (2, [(0, "i8", "padding"), (1, "i32", "stride"),
               (2, "i32", "stride"), (3, "i32", "depth_multiplier"),
               (4, "i8", "act")]),
    "fc": (8, [(0, "i8", "act")]),
    "maxpool": (5, [(0, "i8", "padding"), (1, "i32", "stride"),
                    (2, "i32", "stride"), (3, "i32", "k"),
                    (4, "i32", "k")]),
    "softmax": (9, [(0, "f32", "beta")]),
    "concat": (10, [(0, "i32", "axis")]),
    "add": (11, [(0, "i8", "act")]),
    "l2norm": (12, []),
    "reshape": (17, [(0, "i32v", "shape")]),
    "mul": (21, [(0, "i8", "act")]),
    "pad": (22, []),
    "sub": (28, [(0, "i8", "act")]),
    "slice": (32, []),
    "resize_nn": (74, [(0, "u8", "align_corners"),
                       (1, "u8", "half_pixel_centers")]),
}
_Q_OPTIONS["avgpool"] = _Q_OPTIONS["maxpool"]
_Q_TIED = ("reshape", "concat", "maxpool", "avgpool", "pad", "tile",
           "slice", "resize_nn")


def _same_pads(size, k, stride):
    """TFLite SAME padding (before, after) of one axis."""
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + k - size)
    return total // 2, total - total // 2


def _affine_params(lo, hi):
    """Asymmetric int8 (scale, zero point) covering [lo, hi] and 0."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    scale = max(hi - lo, 1e-6) / 255.0
    zp = int(np.clip(round(-128 - lo / scale), -128, 127))
    return float(np.float32(scale)), zp


class QuantGraph:
    """A full-integer TFLite graph built op by op on a float mirror.

    Each method adds one op (NHWC, batch 1 in the file) and returns its
    output's name; `calibrate(x)` runs the float mirror on a batch and
    records every tensor's range; `tflite()` returns the flatbuffer.
    Tensors that TFLite requires to share quantization with their input
    (RESHAPE, CONCATENATION, pools, PAD, TILE, STRIDED_SLICE,
    RESIZE_NEAREST_NEIGHBOR) take the union range of the group; LOGISTIC
    outputs 1/256 with zero point -128 and L2_NORMALIZATION 1/128 with 0,
    as TFLite's int8 kernels require."""

    def __init__(self, shape, dtype="uint8", qparams=(1 / 128, 128)):
        self.nodes = [("input", "input", [], dict(dtype=dtype,
                                                   q=qparams))]
        self.shape = tuple(shape)
        self.ranges = {}
        self.shapes = {}
        self.outputs = []
        self.postprocess = None

    def _add(self, kind, inputs, **attrs):
        name = f"{kind}{len(self.nodes)}"
        self.nodes.append((name, kind, list(inputs), attrs))
        return name

    # ---- ops ----
    def quantize(self, x):
        return self._add("quantize", [x])

    def conv(self, x, k_hwio, bias=None, stride=1, act=0, padding=0,
             depthwise=False):
        """CONV_2D (k (kh, kw, Cin, Cout)) or DEPTHWISE_CONV_2D (k (kh, kw,
        C)); act 0 none, 1 relu, 3 relu6; padding 0 SAME, 1 VALID."""
        k = np.asarray(k_hwio, np.float32)
        co = k.shape[-1]
        b = np.zeros(co, np.float32) if bias is None else \
            np.asarray(bias, np.float32)
        return self._add("dw" if depthwise else "conv", [x], k=k, b=b,
                         stride=stride, act=act, padding=padding,
                         depth_multiplier=1)

    def fc(self, x, w_io, bias=None, act=0):
        w = np.asarray(w_io, np.float32)
        b = np.zeros(w.shape[1], np.float32) if bias is None else \
            np.asarray(bias, np.float32)
        return self._add("fc", [x], w=w, b=b, act=act)

    def binary(self, kind, x, y=None, const=None, act=0):
        """ADD / SUB / MUL of two tensors, or of a tensor and a constant
        (broadcast over the last axis)."""
        c = None if const is None else np.asarray(const, np.float32)
        return self._add(kind, [x] + ([y] if y is not None else []),
                         const=c, act=act)

    def affine(self, x, a, b):
        """x * a + b per channel: a batch norm the converter keeps
        standalone (MUL and ADD with constant operands)."""
        return self.binary("add", self.binary("mul", x, const=a), const=b)

    def unary(self, kind, x, **attrs):
        """elu, logistic, l2norm, dequantize, softmax (beta 1)."""
        if kind == "softmax":
            attrs.setdefault("beta", 1.0)
        return self._add(kind, [x], **attrs)

    def pool(self, kind, x, k, stride, padding=1):
        return self._add(kind, [x], k=k, stride=stride, padding=padding,
                         act=0)

    def reshape(self, x, shape):
        return self._add("reshape", [x], shape=tuple(shape))

    def concat(self, xs, axis):
        return self._add("concat", list(xs), axis=axis)

    def resize_nn(self, x, size, align_corners=0, half_pixel_centers=0):
        return self._add("resize_nn", [x], size=tuple(size),
                         align_corners=align_corners,
                         half_pixel_centers=half_pixel_centers)

    def pad(self, x, pads):
        return self._add("pad", [x], pads=np.asarray(pads, np.int32))

    def tile(self, x, multiples):
        return self._add("tile", [x],
                         multiples=np.asarray(multiples, np.int32))

    def strided_slice(self, x, begin, end):
        return self._add("slice", [x], begin=np.asarray(begin, np.int32),
                         end=np.asarray(end, np.int32))

    def detection_postprocess(self, boxes, scores, anchors, options):
        self.postprocess = (boxes, scores,
                            np.asarray(anchors, np.float32), options)

    # ---- the float mirror ----
    def _eval(self, kind, xs, at):
        import torch
        import torch.nn.functional as F
        x = xs[0] if xs else None
        if kind in ("quantize", "dequantize"):
            return x
        if kind in ("conv", "dw"):
            k = torch.from_numpy(at["k"])
            s = at["stride"]
            kh, kw = k.shape[:2]
            v = x.permute(0, 3, 1, 2)
            if at["padding"] == 0:
                (pt, pb), (pl, pr) = (_same_pads(v.shape[2], kh, s),
                                      _same_pads(v.shape[3], kw, s))
                v = F.pad(v, (pl, pr, pt, pb))
            w = k.permute(2, 0, 1)[:, None] if kind == "dw" else \
                k.permute(3, 2, 0, 1)
            y = F.conv2d(v, w, torch.from_numpy(at["b"]), stride=s,
                         groups=v.shape[1] if kind == "dw" else 1)
            y = y.permute(0, 2, 3, 1)
            return self._act(y, at["act"])
        if kind == "fc":
            y = x.reshape(x.shape[0], -1) @ torch.from_numpy(at["w"]) \
                + torch.from_numpy(at["b"])
            return self._act(y, at["act"])
        if kind in ("add", "sub", "mul"):
            y = xs[1] if len(xs) > 1 else torch.from_numpy(at["const"])
            out = {"add": x + y, "sub": x - y, "mul": x * y}[kind]
            return self._act(out, at["act"])
        if kind == "elu":
            return F.elu(x)
        if kind == "logistic":
            return torch.sigmoid(x)
        if kind == "l2norm":
            return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                              min=1e-12))
        if kind == "softmax":
            return torch.softmax(x, -1)
        if kind in ("maxpool", "avgpool"):
            k, s = at["k"], at["stride"]
            v = x.permute(0, 3, 1, 2)
            if at["padding"] == 0:
                (pt, pb), (pl, pr) = (_same_pads(v.shape[2], k, s),
                                      _same_pads(v.shape[3], k, s))
            else:
                pt = pb = pl = pr = 0
            if kind == "maxpool":
                y = F.max_pool2d(F.pad(v, (pl, pr, pt, pb),
                                       value=float("-inf")), k, s)
            else:
                ones = torch.ones_like(v[:, :1])
                y = F.avg_pool2d(F.pad(v, (pl, pr, pt, pb)), k, s) / \
                    F.avg_pool2d(F.pad(ones, (pl, pr, pt, pb)), k, s)
            return y.permute(0, 2, 3, 1)
        if kind == "reshape":
            return x.reshape((x.shape[0],) + at["shape"][1:])
        if kind == "concat":
            return torch.cat(xs, at["axis"])
        if kind == "resize_nn":
            rows = self._nn_index(x.shape[1], at["size"][0], at)
            cols = self._nn_index(x.shape[2], at["size"][1], at)
            return x[:, rows][:, :, cols]
        if kind == "pad":
            flat = [int(v) for pair in at["pads"][::-1] for v in pair]
            return F.pad(x, flat)
        if kind == "tile":
            return x.repeat(*[int(m) for m in at["multiples"]])
        if kind == "slice":
            return x[tuple(slice(int(b), int(e))
                           for b, e in zip(at["begin"], at["end"]))]
        raise ValueError(kind)

    @staticmethod
    def _act(y, act):
        import torch
        if act == 1:
            return torch.clamp(y, min=0.0)
        if act == 3:
            return torch.clamp(y, 0.0, 6.0)
        return y

    @staticmethod
    def _nn_index(n_in, n_out, at):
        i = np.arange(n_out, dtype=np.float64)
        if at["half_pixel_centers"]:
            return np.clip(np.floor((i + 0.5) * n_in / n_out).astype(int),
                           0, n_in - 1)
        if at["align_corners"] and n_out > 1:
            return np.clip(np.round(i * (n_in - 1) / (n_out - 1))
                           .astype(int), 0, n_in - 1)
        return np.clip(np.floor(i * n_in / n_out).astype(int), 0, n_in - 1)

    def calibrate(self, x):
        """Run the float mirror on `x` (N, ...) float real values of the
        input; widen every tensor's recorded range."""
        import torch
        vals = {"input": torch.as_tensor(x, dtype=torch.float32)}
        with torch.no_grad():
            for name, kind, ins, at in self.nodes[1:]:
                vals[name] = self._eval(kind, [vals[i] for i in ins], at)
        for name, v in vals.items():
            lo, hi = float(v.min()), float(v.max())
            old = self.ranges.get(name, (lo, hi))
            self.ranges[name] = (min(lo, old[0]), max(hi, old[1]))
            self.shapes[name] = (1,) + tuple(v.shape[1:])
        return vals

    # ---- the flatbuffer ----
    def _qparams(self):
        """Tensor name -> (scale, zero point), or None for float32. A
        tied group takes the parameters of its fixed member (the input,
        LOGISTIC, L2_NORMALIZATION) where it has one, else its union
        range's."""
        group = {n: n for n, _, _, _ in self.nodes}

        def find(n):
            while group[n] != n:
                n = group[n]
            return n
        for name, kind, ins, _ in self.nodes:
            if kind in _Q_TIED:
                for i in ins:
                    group[find(i)] = find(name)
        span, fixed, floats = {}, {}, set()
        in_at = self.nodes[0][3]
        for name, kind, ins, at in self.nodes:
            g = find(name)
            r = self.ranges[name]
            lo, hi = span.get(g, r)
            span[g] = (min(lo, r[0]), max(hi, r[1]))
            if kind == "input":
                if at["dtype"] == "float32":
                    floats.add(name)
                else:
                    fixed.setdefault(g, at["q"])
            elif kind in ("dequantize", "softmax"):
                floats.add(name)
            elif kind == "quantize" and in_at["dtype"] == "uint8":
                fixed.setdefault(g, (in_at["q"][0], in_at["q"][1] - 128))
            elif kind == "logistic":
                fixed.setdefault(g, (1.0 / 256, -128))
            elif kind == "l2norm":
                fixed.setdefault(g, (1.0 / 128, 0))
        return {n: None if n in floats else
                fixed.get(find(n)) or _affine_params(*span[find(n)])
                for n, _, _, _ in self.nodes}

    def tflite(self) -> bytes:
        q = self._qparams()
        tensors, buffers, operators, opcodes = [], [[(0, "u8v", b"")]], [], []
        ids = {}

        def buffer(arr):
            buffers.append([(0, "u8v", np.ascontiguousarray(arr).tobytes())])
            return len(buffers) - 1

        def tensor(name, shape, ttype, data=None, scale=None, zp=None,
                   qdim=0):
            fields = [(0, "i32v", np.asarray(shape, np.int32)),
                      (1, "i8", ttype), (3, "str", name.encode())]
            if data is not None:
                fields.append((2, "u32", buffer(data)))
            if scale is not None:
                scale = np.atleast_1d(np.asarray(scale, np.float32))
                zp = np.zeros(scale.shape, np.int64) if zp is None else \
                    np.broadcast_to(np.asarray(zp, np.int64), scale.shape)
                fields.append((4, "table", [(2, "f32v", scale),
                                            (3, "i64v", zp),
                                            (6, "i32", qdim)]))
            tensors.append(fields)
            return len(tensors) - 1

        def act_tensor(name):
            if q[name] is None:
                return tensor(name, self.shapes[name], 0)
            return tensor(name, self.shapes[name], 9, scale=q[name][0],
                          zp=q[name][1])

        def int8_const(name, c):
            c = np.asarray(c, np.float32)
            s, z = _affine_params(c.min(), c.max())
            data = np.clip(np.round(c / s) + z, -128, 127).astype(np.int8)
            return tensor(name, c.shape, 9, data, s, z)

        def i32_const(name, v):
            v = np.asarray(v, np.int32)
            return tensor(name, v.shape, 2, v)

        def opcode(code, custom=None):
            key = (code, custom)
            if key not in opcodes:
                opcodes.append(key)
            return opcodes.index(key)

        def operator(kind, ins, outs, at=None, custom=None, options=None):
            fields = [(0, "u32", opcode(_Q_CODES[kind], custom)),
                      (1, "i32v", np.asarray(ins, np.int32)),
                      (2, "i32v", np.asarray(outs, np.int32))]
            if kind in _Q_OPTIONS:
                utype, spec = _Q_OPTIONS[kind]
                table = [(slot, fk, (np.asarray(at[a], np.int32)
                                     if fk == "i32v" else at[a]))
                         for slot, fk, a in spec]
                fields += [(3, "u8", utype), (4, "table", table)]
            if options is not None:
                fields += [(5, "u8v", options), (6, "i8", 0)]
            operators.append(fields)

        for name, kind, ins, at in self.nodes:
            if kind == "input":
                dt = {"uint8": 3, "int8": 9, "float32": 0}[at["dtype"]]
                ids[name] = tensor(name, self.shape, dt,
                                   **({} if q[name] is None else
                                      dict(scale=q[name][0],
                                           zp=q[name][1])))
                continue
            src = [ids[i] for i in ins]
            out = act_tensor(name)
            if kind in ("conv", "dw", "fc"):
                s_in = q[ins[0]][0]
                if kind == "fc":
                    w = at["w"].T                              # (O, I)
                    s_w = np.float32(max(np.abs(w).max(), 1e-8) / 127)
                    w8 = np.clip(np.round(w / s_w), -127, 127)
                    wt = tensor(f"{name}/weights", w.shape, 9,
                                w8.astype(np.int8), s_w, 0)
                    bscale = np.float32(np.float64(s_in) * s_w)
                else:
                    k = at["k"]                  # (kh, kw, Cin, Cout)
                    s_w = np.maximum(np.abs(k).reshape(-1, k.shape[-1])
                                     .max(0), 1e-8) / 127
                    s_w = s_w.astype(np.float32)
                    k8 = np.clip(np.round(k / s_w), -127, 127).astype(
                        np.int8)
                    if kind == "dw":             # (1, kh, kw, C), axis 3
                        data = k8[None]
                        qdim = 3
                    else:                        # OHWI, axis 0
                        data = np.transpose(k8, (3, 0, 1, 2))
                        qdim = 0
                    wt = tensor(f"{name}/weights", data.shape, 9, data,
                                s_w, 0, qdim)
                    bscale = (np.float64(s_in) * s_w.astype(np.float64)
                              ).astype(np.float32)
                b32 = np.round(at["b"] / bscale.astype(np.float64)).astype(
                    np.int32)
                bt = tensor(f"{name}/bias", b32.shape, 2, b32, bscale, 0,
                            0)
                operator(kind, src + [wt, bt], [out], at)
            elif kind in ("add", "sub", "mul") and at["const"] is not None:
                operator(kind, src + [int8_const(f"{name}/c", at["const"])],
                         [out], at)
            elif kind == "reshape":
                at = dict(at, shape=self.shapes[name])
                operator(kind, src + [i32_const(f"{name}/shape",
                                                at["shape"])], [out], at)
            elif kind == "resize_nn":
                operator(kind, src + [i32_const(f"{name}/size",
                                                at["size"])], [out], at)
            elif kind == "pad":
                operator(kind, src + [i32_const(f"{name}/pads",
                                                at["pads"])], [out], at)
            elif kind == "tile":
                operator(kind, src + [i32_const(f"{name}/multiples",
                                                at["multiples"])], [out], at)
            elif kind == "slice":
                operator(kind, src + [
                    i32_const(f"{name}/begin", at["begin"]),
                    i32_const(f"{name}/end", at["end"]),
                    i32_const(f"{name}/strides", np.ones_like(at["begin"]))],
                    [out], at)
            else:
                operator(kind, src, [out], at)
            ids[name] = out
        if self.postprocess is not None:
            boxes, scores, anchors, options = self.postprocess
            m = options["max_detections"]
            outs = [tensor("TFLite_Detection_PostProcess" + s, shape, 0)
                    for s, shape in (("", (1, m, 4)), (":1", (1, m)),
                                     (":2", (1, m)), (":3", (1,)))]
            operator("custom", [ids[boxes], ids[scores],
                                tensor("anchors", anchors.shape, 0,
                                       anchors)],
                     outs, custom=b"TFLite_Detection_PostProcess",
                     options=_flex_map(options))
            outputs = outs
        else:
            outputs = [ids[n] for n in self.outputs]
        codes = [[(0, "i8", min(code, 127)), (2, "i32", 1), (3, "i32", code)]
                 + ([(1, "str", custom)] if custom else [])
                 for code, custom in opcodes]
        subgraph = [(0, "tables", tensors),
                    (1, "i32v", np.asarray([ids["input"]], np.int32)),
                    (2, "i32v", np.asarray(outputs, np.int32)),
                    (3, "tables", operators)]
        return _fb_serialize([(0, "u32", 3), (1, "tables", codes),
                              (2, "tables", [subgraph]),
                              (4, "tables", buffers)])


def _bn_affine(bn):
    """A port BatchNorm as per-channel (a, b), y = x * a + b."""
    import torch
    a = (bn.weight * torch.rsqrt(bn.running_var + bn.eps)).detach()
    return a.numpy(), (bn.bias - bn.running_mean * a).detach().numpy()


def _fold_bn(conv_w, bn):
    """A port conv weight (O, I, kh, kw) with the batch norm after it
    folded: (kernel (kh, kw, I, O), bias (O,))."""
    a, b = _bn_affine(bn)
    w = conv_w.detach().numpy() * a[:, None, None, None]
    return np.transpose(w, (2, 3, 1, 0)), b


def quantized_ssd_graph(ssd, size, calib, pp_options=None):
    """A port SSDMobileNetV1 (float, on the CPU) as a full-integer graph at
    input `size`: uint8 input (scale 1/128, zero point 128, the zoo
    files'), QUANTIZE to int8, the backbone's CONV_2D / DEPTHWISE_CONV_2D
    with folded batch norms and fused relu6, the extras, the 1x1 heads,
    each RESHAPEd and CONCATENATed by kind, LOGISTIC on the class scores,
    then (with `pp_options`) a TFLite_Detection_PostProcess op on the
    generated anchors (raw int8 heads without it). `calib`: (N, size,
    size, 3) raw pixels."""
    from deepdish_tpu_torch.models.ssd_mobilenet import (_BACKBONE, _EXTRAS,
                                                         generate_anchors)
    g = QuantGraph((1, size, size, 3))
    x = g.quantize("input")
    k, b = _fold_bn(ssd.conv0.conv.weight, ssd.conv0.bn)
    x = g.conv(x, k, b, stride=2, act=3)
    feats = []
    for i, (_, s) in enumerate(_BACKBONE):
        blk = getattr(ssd, f"ds{i + 1}")
        k, b = _fold_bn(blk.dw.weight, blk.dw_bn)
        x = g.conv(x, k[:, :, 0], b, stride=s, act=3, depthwise=True)
        k, b = _fold_bn(blk.pw.weight, blk.pw_bn)
        x = g.conv(x, k, b, act=3)
        if i == 10:
            feats.append(x)
    feats.append(x)
    for i in range(len(_EXTRAS)):
        for part, s in (("1x1", 1), ("3x3", 2)):
            m = getattr(ssd, f"extra{i}_{part}")
            k, b = _fold_bn(m.conv.weight, m.bn)
            x = g.conv(x, k, b, stride=s, act=3)
        feats.append(x)
    boxes, scores = [], []
    for lv, f in enumerate(feats):
        for kind, out, width in (("box", boxes, 4),
                                 ("cls", scores, ssd.num_classes + 1)):
            m = getattr(ssd, f"{kind}_head{lv}")
            h = g.conv(f, m.weight.detach().permute(2, 3, 1, 0).numpy(),
                       m.bias.detach().numpy())
            out.append(g.reshape(h, (1, -1, width)))
    box_t, cls_t = g.concat(boxes, 1), g.concat(scores, 1)
    if pp_options is not None:
        # TFLite's postprocess op reads float (or uint8) inputs: the int8
        # heads are dequantized, the scores after an in-graph LOGISTIC
        g.detection_postprocess(
            g.unary("dequantize", box_t),
            g.unary("dequantize", g.unary("logistic", cls_t)),
            generate_anchors(size), pp_options)
    else:
        g.outputs = [box_t, cls_t]
    g.calibrate((np.asarray(calib, np.float32) - 128.0) / 128.0)
    return g


def quantized_mars_graph(mars, calib):
    """A port MarsNet (float, on the CPU) as a full-integer graph: float
    input, QUANTIZE (pixels at scale 1), CONV_2D with folded batch norms,
    int8 ELU, MAX_POOL_2D 3x3/2 VALID, the residual blocks (standalone
    pre-activation batch norms as MUL + ADD with constants, residual ADDs,
    1x1/2 projections), RESHAPE, FULLY_CONNECTED with fc1_bn folded, ELU,
    the `ball` batch norm as MUL + ADD, int8 L2_NORMALIZATION, DEQUANTIZE.
    `calib`: (N, 128, 64, 3) raw pixels."""
    g = QuantGraph((1, 128, 64, 3), dtype="float32")
    x = g.quantize("input")
    for conv, bn in (("conv1_1", "conv1_1_bn"), ("conv1_2", "conv1_2_bn")):
        k, b = _fold_bn(getattr(mars, conv).weight, getattr(mars, bn))
        x = g.unary("elu", g.conv(x, k, b))
    x = g.pool("maxpool", x, 3, 2, padding=1)
    for name in ("conv2_1", "conv2_3", "conv3_1", "conv3_3", "conv4_1",
                 "conv4_3"):
        blk = getattr(mars, name)
        pre = x if blk.is_first else g.unary(
            "elu", g.affine(x, *_bn_affine(blk.pre_bn)))
        s = 2 if blk.increase_dim else 1
        k, b = _fold_bn(blk.inner.conv1.weight, blk.inner.bn1)
        y = g.unary("elu", g.conv(pre, k, b, stride=s))
        c2 = blk.inner.conv2
        y = g.conv(y, c2.weight.detach().permute(2, 3, 1, 0).numpy(),
                   c2.bias.detach().numpy())
        if blk.increase_dim:
            short = g.conv(x, blk.projection.weight.detach()
                           .permute(2, 3, 1, 0).numpy(), stride=2)
        else:
            short = x
        x = g.binary("add", short, y)
    x = g.reshape(x, (1, 16 * 8 * 128))
    a, b = _bn_affine(mars.fc1_bn)
    x = g.unary("elu", g.fc(x, mars.fc1.weight.detach().numpy().T * a, b))
    x = g.affine(x, *_bn_affine(mars.ball))
    g.outputs = [g.unary("dequantize", g.unary("l2norm", x))]
    g.calibrate(calib)
    return g


def quantized_op_graphs(seed=SEED + 50):
    """One small full-integer graph per op the YOLOv5 and EfficientDet
    files use beyond the SSD's and MARS's: int8 input (1, 8, 8, 16) at
    scale 0.05, zero point 3, the op, int8 (or, for SOFTMAX, float32)
    output. Returns {op name: QuantGraph}, calibrated on seeded noise."""
    rng = np.random.RandomState(seed)
    x_real = (rng.randint(-128, 128, (4, 8, 8, 16)) - 3) * 0.05
    const = rng.uniform(-2.0, 2.0, 16)
    builds = {
        "LOGISTIC": lambda g, x: g.unary("logistic", x),
        "RESIZE_NEAREST_NEIGHBOR": lambda g, x: g.resize_nn(
            x, (16, 12), half_pixel_centers=1),
        "CONCATENATION": lambda g, x: g.concat(
            [x, g.binary("mul", x, const=const)], 3),
        "STRIDED_SLICE": lambda g, x: g.strided_slice(
            x, (0, 1, 2, 0), (1, 7, 8, 16)),
        "PAD": lambda g, x: g.pad(x, ((0, 0), (1, 2), (2, 1), (0, 0))),
        "TILE": lambda g, x: g.tile(x, (1, 2, 3, 1)),
        "AVERAGE_POOL_2D": lambda g, x: g.pool("avgpool", x, 3, 2,
                                               padding=0),
        "SUB": lambda g, x: g.binary("sub", x, const=const),
        "MUL": lambda g, x: g.binary("mul", x, g.unary("logistic", x)),
        "SOFTMAX": lambda g, x: g.unary("softmax",
                                        g.unary("dequantize", x)),
    }
    graphs = {}
    for op, build in builds.items():
        g = QuantGraph((1, 8, 8, 16), dtype="int8", qparams=(0.05, 3))
        g.outputs = [build(g, "input")]
        g.calibrate(x_real)
        graphs[op] = g
    return graphs


QUANT_CHUNK = 8            # the phase's batch and CLI chunk size
QUANT_CLS_GAIN = 1000.0    # class-head gain of the written SSD


def quant_ssd_donor():
    """The CLI's default random SSD-MobileNetV1 (flax's draw, seed 0), its
    class heads scaled by QUANT_CLS_GAIN: the random heads' logits are
    ~1e-4, which the int8 LOGISTIC (steps of 1/256) would turn into ties;
    scaled, the scores spread, in the float model's order (one positive
    gain keeps every logit's rank, and the sigmoid is monotonic)."""
    import torch
    from deepdish_tpu_torch.models.layers import flax_default_init_
    from deepdish_tpu_torch.models.ssd_mobilenet import SSDMobileNetV1
    ssd = SSDMobileNetV1()
    flax_default_init_(ssd, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for lv in range(6):
            getattr(ssd, f"cls_head{lv}").weight.mul_(QUANT_CLS_GAIN)
    return ssd


@contextlib.contextmanager
def _cpu_quantization():
    """The w8a8 modes' post-training quantization (models/ssd_q.py
    `quantize_ssd`, models/mars_q.py `quantize_mars`) computed once on the
    CPU and reused by every run in the block, on the card and on the CPU:
    a float32 card-vs-CPU CLI comparison then holds one quantization, not
    two calibrations that differ in the last bits of float32 sums."""
    from deepdish_tpu_torch.models import mars_q, ssd_q
    saved = (ssd_q.quantize_ssd, mars_q.quantize_mars)
    cache = {}

    def key(params):
        return tuple((k, float(v.double().sum()))
                     for k, v in sorted(params.items()))

    def cpu(params):
        return {k: v.detach().cpu() for k, v in params.items()}

    def ssd(params, quantize_dw=False, calib_images=None):
        k = ("ssd", key(params), quantize_dw)
        if k not in cache:
            cache[k] = saved[0](cpu(params), quantize_dw, calib_images)
        return cache[k]

    def mars(params, calib_patches=None, compute_dtype=None):
        k = ("mars", key(params), compute_dtype)
        if k not in cache:
            cache[k] = saved[1](cpu(params), calib_patches, compute_dtype)
        return cache[k]
    ssd_q.quantize_ssd, mars_q.quantize_mars = ssd, mars
    try:
        yield
    finally:
        ssd_q.quantize_ssd, mars_q.quantize_mars = saved


def _env_card_vs_cpu(path, x, dev, impls=("auto", "portable")):
    """Every tensor of the integer executor on the card (each conv_impl)
    against the CPU executor's on the same input x (N, ...): integer
    tensors equal, float32 ones (DEQUANTIZE) bit-equal, SOFTMAX's
    probabilities within 5e-7 (exp of two libraries). Returns (ops,
    problems, card ms of one apply per impl)."""
    import torch
    from deepdish_tpu_torch.models.qgraph import SOFTMAX, QGraphExecutor
    host = QGraphExecutor(path, device="cpu")
    want = host.apply(x, return_env=True)
    problems, ms = [], {}
    for impl in impls:
        ex = QGraphExecutor(path, conv_impl=impl, device=dev)
        xd = x.to(dev)
        ex.apply(xd)
        _sync(dev)
        t0 = time.perf_counter()
        env = ex.apply(xd, return_env=True)
        _sync(dev)
        ms[impl] = (time.perf_counter() - t0) * 1e3
        for qop in ex.ops:
            got = env[qop.outputs[0]].cpu()
            ref = want[qop.outputs[0]]
            if got.dtype != ref.dtype or got.shape != ref.shape:
                problems.append(f"{impl} {qop.name}: {got.dtype} "
                                f"{tuple(got.shape)} vs {ref.dtype} "
                                f"{tuple(ref.shape)}")
            elif qop.code == SOFTMAX:
                if not torch.allclose(got, ref, rtol=0, atol=5e-7):
                    problems.append(f"{impl} {qop.name}: softmax differs "
                                    f"by {float((got - ref).abs().max())}")
            elif not torch.equal(got, ref):
                problems.append(f"{impl} {qop.name} (op {qop.code}): "
                                f"{int((got != ref).sum())} elements differ")
    return len(host.ops), problems, ms


def _w8a8_card_vs_cpu(forward, qparams, strides, x, dev):
    """A w8a8 forward (ssd_q.ssd_forward / mars_q.mars_forward) on the CPU
    recording each layer's (int8 input, accumulator), then each layer's
    contraction (stride `strides[path]`) on the card on the same int8
    input: accumulators equal. Returns (layers, problems, the card
    forward's outputs)."""
    import torch
    from deepdish_tpu_torch.models import mars_q, ssd_q
    module = ssd_q if forward is ssd_q.ssd_forward else mars_q
    qp_cpu = module.prepare_qparams(qparams, "cpu")
    qp_dev = module.prepare_qparams(qparams, dev)
    accs = {}
    with torch.inference_mode():
        forward(qp_cpu["base"], x, qparams=qp_cpu, acc_sink=accs)
        problems = []
        for path, (v8, acc) in accs.items():
            w = qparams["wq"][path]
            v8d = v8.to(dev)
            if v8.dim() == 2:
                got = mars_q.int8_matmul(v8d, qp_dev["wmat"][path],
                                         w.shape[-1])
            elif qparams.get("layers", {}).get(path, (0, 0, False))[2]:
                got = ssd_q._dw_i8(v8d, qp_dev["wmat"][path], strides[path])
            else:
                got = mars_q.conv_i8(v8d, qp_dev["wmat"][path], w.shape[0],
                                     w.shape[1], strides[path], w.shape[-1])
            if path in qparams.get("corr", {}):
                got = got + qp_dev["corr_t"][path]
            if not torch.equal(got.cpu(), acc):
                problems.append(f"{path}: {int((got.cpu() != acc).sum())} "
                                "accumulators differ")
        out = forward(qp_dev["base"], x.to(dev), qparams=qp_dev)
    return len(accs), problems, out


def _profile_chunk(fs, frames, dev, tag):
    """torch.profiler over one run_chunk of the frames (after one warm-up
    run): per frame, the device time of the integer contractions
    (aten::_int_mm, the cuBLASLt int8 GEMM) and of the int32 depthwise
    taps (the qgraph.depthwise range), the device's busy time and the
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = fs.init_state()
    state, _, _ = fs.run_chunk(state, frames)
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _, _ = fs.run_chunk(state, frames)
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(frames)
    by = {e.key: e for e in prof.key_averages()}
    int_mm = by["aten::_int_mm"].device_time_total / n / 1e3 \
        if "aten::_int_mm" in by else 0.0
    calls = by["aten::_int_mm"].count / n if "aten::_int_mm" in by else 0
    dw = by["qgraph.depthwise"].device_time_total / n / 1e3 \
        if "qgraph.depthwise" in by else 0.0
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[quantized] {tag}: run_chunk({n}) profiled: aten::_int_mm "
        f"{int_mm:.3f} ms/frame device ({calls:.0f} calls/frame), "
        f"int32 depthwise taps {dw:.3f} ms/frame device, device busy "
        f"{busy_us / n / 1e3:.3f} of {wall_us / n / 1e3:.3f} ms/frame wall "
        f"(idle share {1 - busy_us / max(wall_us, 1e-9):.3f}); top kernels: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total / n:.1f} us"
                    for e in sorted(kernels, key=lambda e:
                                    -e.self_device_time_total)[:4]))
    return int_mm


def phase_quantized(dev):
    """The quantized paths at full width. Full-integer files written by the
    script (`QuantGraph`), quantized on the walker scene: SSD-MobileNetV1
    at 300 (91 classes, LOGISTIC and a TFLite_Detection_PostProcess op)
    from `quant_ssd_donor` and MARS at 128x64 (int8 ELU, MAX_POOL_2D,
    L2_NORMALIZATION) from a seeded donor with batch norms calibrated on
    the scene, and one graph per op the YOLOv5 and EfficientDet files add;
    every tensor of the integer executor on the card (the "mxu" form:
    torch._int_mm, the "portable" form: float64, and for the SSD the
    "xconv" form: a float64 direct convolution)
    against the CPU executor's on QUANT_CHUNK inputs; the quantized SSD's
    detections card vs CPU (`_compare_detections`); the w8a8 SSD (300) and
    MARS (128x64) accumulators on the card against the CPU's on the same
    int8 inputs, batch QUANT_CHUNK; the integer contractions' device time
    per frame under the profiler; the CLI at --chunk-size 8 with
    --quantized-inference on the two files and with --detector-int8
    --encoder-model mars_int8 on the default random SSD (bf16: objd, e2e, host
    syncs a frame, LSAP launches > 0), each also in float32 on the card and
    on the CPU over phase 7's float32 frames, whose counters must agree and
    not all be 0. Returns the LSAP launches of the bf16 CLI runs."""
    import tempfile

    import torch
    from deepdish_tpu_torch import device as devmod
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import (COCO_LABELS, create_box_encoder,
                                           create_detector, mars_q, ssd_q)
    from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
    from deepdish_tpu_torch.models.preprocess import resize_bilinear_mxu
    from deepdish_tpu_torch.models.ssd_mobilenet import INPUT_SIZE
    t_phase = time.perf_counter()
    n = QUANT_CHUNK
    scene = np.ascontiguousarray(np.stack(
        [_cli_scene(CLI_START + 3 * k) for k in range(n)])[..., ::-1])
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the files, quantized on the scene
        t0 = time.perf_counter()
        ssd = quant_ssd_donor()
        mars = MarsNet()
        _calibrated_init(mars, torch.Generator().manual_seed(SEED + 1),
                         _calibration_images(*INPUT_SHAPE[:2]))
        resized = resize_bilinear_mxu(torch.from_numpy(scene), INPUT_SIZE,
                                      INPUT_SIZE, torch.float32)
        ssd_path = f"{tmp}/ssd_mobilenet_v1_coco_quant_postprocess.tflite"
        mars_path = f"{tmp}/mars-little128_int8.tflite"
        graphs = {ssd_path: quantized_ssd_graph(
                      ssd, INPUT_SIZE, resized.numpy(), _ssd_pp_options()),
                  mars_path: quantized_mars_graph(
                      mars, _calibration_images(*INPUT_SHAPE[:2]).numpy())}
        for op, g in quantized_op_graphs().items():
            graphs[f"{tmp}/{op.lower()}_int8.tflite"] = g
        for path, g in graphs.items():
            with open(path, "wb") as f:
                f.write(g.tflite())
        log(f"[quantized] {len(graphs)} full-integer files calibrated and "
            f"written in {time.perf_counter() - t0:.1f} s (SSD "
            f"{len(open(ssd_path, 'rb').read()) / 2 ** 20:.1f} MiB, MARS "
            f"{len(open(mars_path, 'rb').read()) / 2 ** 20:.1f} MiB)")

        # 2. the executor on the card against the CPU, every tensor
        x_ssd = torch.clamp(torch.floor(resized + 0.5), 0, 255).to(
            torch.uint8)
        patches = torch.cat([
            _calibration_images(*INPUT_SHAPE[:2]),
            torch.from_numpy(np.random.RandomState(SEED + 41).uniform(
                0, 255, (n - 4,) + INPUT_SHAPE).astype(np.float32))])
        x_op = torch.from_numpy(np.random.RandomState(SEED + 42).randint(
            -128, 128, (n, 8, 8, 16)).astype(np.int8))
        problems = []
        for path in graphs:
            x = x_ssd if path == ssd_path else patches \
                if path == mars_path else x_op
            impls = ("auto", "portable", "xconv") if path == ssd_path \
                else ("auto", "portable")
            t0 = time.perf_counter()
            n_ops, bad, ms = _env_card_vs_cpu(path, x, dev, impls)
            problems += bad
            log(f"[quantized] executor card vs CPU "
                f"{path.rsplit('/', 1)[1]}: {n_ops} ops, batch {len(x)}, "
                f"{len(bad)} tensors differ; card ms per apply "
                + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                + f" ({time.perf_counter() - t0:.1f} s)")
        if problems:
            raise SystemExit(f"quantized: executor card vs CPU: "
                             f"{problems[:8]}")

        # 3. the quantized SSD's detections, card vs CPU
        outs = []
        for d in (dev, torch.device("cpu")):
            det = create_detector(ssd_path, quantized=True, device=d,
                                  score_threshold=TFLITE_THRESHOLD)
            raw = det.detect(resized.to(d), float(FRAME_W), float(FRAME_H))
            outs.append([t.cpu().numpy() for t in raw])
        report, serr, berr = [], 0.0, 0.0
        for i in range(n):
            p, se, be = _compare_detections(*([t[i] for t in o]
                                              for o in outs))
            report += [f"frame {i}: {m}" for m in p]
            serr, berr = max(serr, se), max(berr, be)
        n_valid = [int(v.sum()) for v in outs[1][3]]
        log(f"[quantized] QuantizedSSDDetector card vs CPU on {n} resized "
            f"720p frames, valid {n_valid}: {len(report)} problems, max "
            f"|score| error {serr:.3e}, max box error {berr:.3e}")
        if report or serr > 1e-6 or berr > 1e-5 or max(n_valid) <= 0:
            raise SystemExit(f"quantized: detections card vs CPU "
                             f"{report[:6]}")

        # 4. w8a8 accumulators on the card against the CPU's
        sd = {k: v.detach() for k, v in ssd.state_dict().items()}
        t0 = time.perf_counter()
        qp = ssd_q.quantize_ssd(sd, calib_images=resized.numpy())
        layers, bad, _ = _w8a8_card_vs_cpu(
            ssd_q.ssd_forward, qp,
            {p: stride for p, (_, stride, _) in qp["layers"].items()},
            resized, dev)
        problems = bad
        msd = {k: v.detach() for k, v in mars.state_dict().items()}
        mqp = mars_q.quantize_mars(msd, patches.numpy())
        strides = {p: 2 if p.startswith(("conv3_1", "conv4_1")) and
                   not p.endswith("conv2") else 1
                   for p in mars_q.QUANTIZED_LAYERS}
        mlayers, bad, _ = _w8a8_card_vs_cpu(
            mars_q.mars_forward, mqp, strides, patches, dev)
        problems += bad
        log(f"[quantized] w8a8 accumulators card vs CPU on the same int8 "
            f"inputs, batch {n}: SSD 300 {layers} layers, MARS 128x64 "
            f"{mlayers} layers, {len(problems)} differ "
            f"({time.perf_counter() - t0:.1f} s)")
        if problems or layers != 33 or mlayers != 16:
            raise SystemExit(f"quantized: w8a8 accumulators {problems[:6]}")

        # 5. the integer contractions' device time per frame
        frames = torch.from_numpy(scene).to(dev)
        int_mm = {}
        for tag, det, enc in (
                ("--quantized-inference",
                 create_detector(ssd_path, quantized=True, device=dev),
                 create_box_encoder(mars_path, device=dev)),
                ("--detector-int8 mars_int8",
                 create_detector("ssd_mobilenet_int8", device=dev,
                                 generator=torch.Generator().manual_seed(
                                     SEED)),
                 create_box_encoder("mars_int8", device=dev))):
            fs = _framestep(dev, (FRAME_H, FRAME_W), detector=det,
                            encoder=enc)
            int_mm[tag] = _profile_chunk(fs, frames, dev, tag)
            del fs, det, enc

        # 6. the CLI on the card (bf16), then float32 card vs CPU
        runs = {
            "--quantized-inference": ["--quantized-inference", "--model",
                                      ssd_path, "--encoder-model",
                                      mars_path],
            "--detector-int8 mars_int8": ["--detector-int8", "--model",
                                          "ssd_mobilenet", "--encoder-model",
                                          "mars_int8"]}
        common = ["--input", "synthetic://walkers", "--disable-graphics",
                  "--streaming", "0", "--control-port", "0",
                  "--wanted-labels", ",".join(COCO_LABELS),
                  "--score-threshold", str(TFLITE_THRESHOLD),
                  "--chunk-size", str(QUANT_CHUNK)]
        launches = 0
        skip = 8
        for tag, argv in runs.items():
            lsap.launches = 0
            devmod.host_syncs = 0
            t0 = time.perf_counter()
            pipe, timing, nf, bad = _run_cli(
                common + argv + ["--device", dev.type, "--log",
                                 f"{tmp}/q.log"], CLI_FRAMES)
            syncs = devmod.host_syncs
            launches += lsap.launches
            det = pipe.framestep.detector
            counters = {k: v for k, v in
                        pipe.counting.counters_payload().items() if v}
            log(f"[quantized] CLI 720p {tag} --chunk-size {QUANT_CHUNK} "
                f"({type(det).__name__}, {det.compute_dtype}, bgsub on): "
                f"{nf} frames in {time.perf_counter() - t0:.1f} s, objd "
                f"{float(np.mean(timing['objd'][skip:])):.3f} ms/frame, e2e "
                f"{float(np.mean(timing['e2e'][skip:])):.3f} ms/frame (mean "
                f"over frames {skip + 1}-{nf}), {syncs / max(nf, 1):.2f} "
                f"host syncs/frame, {lsap.launches} LSAP launches, {bad} "
                f"frames with non-finite outputs; nonzero counters "
                f"{counters}")
            if nf != CLI_FRAMES or bad or lsap.launches <= 0:
                raise SystemExit(f"quantized: CLI {tag}: {nf} frames, {bad} "
                                 f"non-finite, {lsap.launches} launches")
            del pipe, det
            f32 = []
            with _float32_models(), _cpu_quantization():
                for d in (dev.type, "cpu"):
                    t0 = time.perf_counter()
                    # 8 crops a frame: the CPU's integer executor
                    # keeps this comparison inside the phase's time
                    pipe, _, nf, bad = _run_cli(
                        common + argv + ["--device", d, "--encode-capacity",
                                         "8", "--log", f"{tmp}/q32_{d}.log"],
                        CLI_SHORT_FRAMES, CLI_SHORT_FIRST)
                    f32.append(pipe.counting.counters_payload())
                    log(f"[quantized] CLI float32 {tag} on {d}: {nf} frames "
                        f"in {time.perf_counter() - t0:.1f} s, counters "
                        f"{ {k: v for k, v in f32[-1].items() if v} }")
                    del pipe
            if f32[0] != f32[1] or not any(f32[1].values()):
                raise SystemExit(f"quantized: CLI {tag} float32 counters "
                                 f"card {f32[0]} vs CPU {f32[1]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(f"[quantized] card: {smi.stdout.strip() or 'nvidia-smi: no output'}"
        f"; integer contractions (aten::_int_mm) ms/frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in int_mm.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 13

PAR_STREAMS = 16           # bench.py's config 5: 16 concurrent 720p streams
PAR_CHUNK = 8              # frames a stream a call (bench.py --stream-chunk)
PAR_SHIFT = 48             # px: stream s is the walker scene rolled s * 48
PAR_STAGES = ("framestep.upload", "framestep.resize", "ssd.net",
              "ssd.decode_nms", "framestep.filter_nms",
              "framestep.crop_mars", "framestep.tracker")


def _stream_chunks(n_streams, n_calls):
    """(n_calls, S, PAR_CHUNK, 720, 1280, 3) RGB uint8: stream s is the
    walker scene from frame CLI_START on, rolled s * PAR_SHIFT px along x;
    call c holds its frames c * PAR_CHUNK ... (c + 1) * PAR_CHUNK - 1."""
    chunk = PAR_CHUNK
    n = n_calls * chunk
    scene = np.stack([_cli_scene(CLI_START + i)[..., ::-1]
                      for i in range(n)])
    out = np.empty((n_calls, n_streams, chunk) + scene.shape[1:], np.uint8)
    for s in range(n_streams):
        rolled = np.roll(scene, s * PAR_SHIFT, axis=2)
        out[:, s] = rolled.reshape((n_calls, chunk) + scene.shape[1:])
    return out


def _par_donors():
    """SSD-MobileNetV1 and MARS state dicts: seeded draws with batch norms
    calibrated on the walker scene (`_calibrated_init`)."""
    import torch
    from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
    from deepdish_tpu_torch.models.ssd_mobilenet import (INPUT_SIZE,
                                                         SSDMobileNetV1)
    ssd = SSDMobileNetV1()
    _calibrated_init(ssd, torch.Generator().manual_seed(SEED),
                     _calibration_images(INPUT_SIZE, INPUT_SIZE))
    mars = MarsNet()
    _calibrated_init(mars, torch.Generator().manual_seed(SEED + 1),
                     _calibration_images(*INPUT_SHAPE[:2]))
    return ({k: v.detach() for k, v in ssd.state_dict().items()},
            {k: v.detach() for k, v in mars.state_dict().items()})


def _par_framestep(dev, donors, dtype, wanted, num_labels, step_cfg=None):
    """bench.py's config 5 FrameStep on the donors: SSD 300 (max_outputs
    32) + MARS 128x64, T = 64, D = 32, G = 64, encode capacity 8, bgsub
    off unless `step_cfg` says otherwise."""
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import create_box_encoder, create_detector
    from deepdish_tpu_torch.pipeline import FrameStep, FrameStepConfig
    det = create_detector("ssd_mobilenet", state_dict=donors[0], device=dev,
                          max_outputs=32, compute_dtype=dtype)
    enc = create_box_encoder("mars", state_dict=donors[1], device=dev,
                             compute_dtype=dtype)
    cfg = tt.TrackerConfig(max_tracks=64, max_detections=32,
                           gallery_size=64, num_labels=num_labels)
    return FrameStep(det, enc, cfg, wanted, (FRAME_H, FRAME_W),
                     step_cfg or FrameStepConfig(encode_capacity=8),
                     device=dev)


def _stream_problems(a, b, tag, box_px):
    """One stream's (outs, snaps), each stacked on F, against another's:
    per frame the detections order-free among scores tied to 1e-5
    (`_compare_detections`), box coordinates within `box_px` pixels (a
    truncation that float32 noise may flip moves a box by one), the track
    ids and states exact, and each track's matched box within `box_px`.
    Returns (problems, max score error, max box error in pixels)."""
    import torch
    problems, serr, berr = [], 0.0, 0.0
    (oa, sa), (ob, sb) = a, b
    for f in range(oa.track_id.shape[0]):
        dets = [[t[f].cpu().numpy() for t in (s.tlwh, s.label, s.score,
                                              s.valid)] for s in (sa, sb)]
        p, se, be = _compare_detections(*dets)
        scale = max(float(np.abs(dets[1][0][:int(dets[1][3].sum())])
                          .max(initial=0)), 1.0)
        serr, berr = max(serr, se), max(berr, be * scale)
        problems += [f"{tag} frame {f}: {m}" for m in p]
        for name in ("track_id", "state"):
            if not torch.equal(getattr(oa, name)[f].cpu(),
                               getattr(ob, name)[f].cpu()):
                problems.append(f"{tag} frame {f}: {name} differ")
        boxes = []
        for o, s in ((oa, sa), (ob, sb)):
            m = o.matched_det[f].long().cpu()
            boxes.append(torch.where((m >= 0)[:, None],
                                     s.tlwh[f].cpu()[m.clamp(min=0)], -1.0))
        if float((boxes[0] - boxes[1]).abs().max()) > box_px:
            problems.append(f"{tag} frame {f}: matched boxes differ")
    if berr > box_px:
        problems.append(f"{tag}: boxes differ by {berr} px")
    return problems, serr, berr


def _select(tree, s):
    """Stream s of a NamedTuple stacked (S, ...)."""
    return type(tree)(*(t[s] for t in tree))


def _par_demo(dev):
    """tools/multistream_demo.main at 720p on 3 streams of the walker scene
    (`open_loader` replaced by an in-memory loader), --max-frames 8."""
    from deepdish_tpu_torch.tools import multistream_demo

    class SceneLoader:
        def __init__(self, paths, width, height):
            self.chunks = iter(_stream_chunks(len(paths), 1))

        def next_chunk(self, chunk):
            frames = next(self.chunks, None)
            if frames is None:
                return None, None, 0
            counts = np.full((len(frames),), frames.shape[1], np.int32)
            return frames, counts, int(counts.sum())

        def close(self):
            pass

    saved = multistream_demo.open_loader
    multistream_demo.open_loader = SceneLoader
    try:
        return multistream_demo.main(
            ["--inputs", "walkers0", "walkers1", "walkers2",
             "--max-frames", "8"])
    finally:
        multistream_demo.open_loader = saved


def _par_mot(dev, mars_sd, tmp):
    """tools/mot_features.extract_sequence on a three-frame synthetic MOT
    sequence (JPEG frames of the walker scene, two boxes a frame) with the
    calibrated MARS in float32, on the card and on the CPU. Returns (rows,
    max feature difference)."""
    import os

    import cv2
    import torch
    from deepdish_tpu_torch.models import create_box_encoder
    from deepdish_tpu_torch.tools import mot_features
    seq = os.path.join(tmp, "SEQ-01")
    os.makedirs(os.path.join(seq, "img1"))
    os.makedirs(os.path.join(seq, "det"))
    dets = []
    for f in range(1, 4):
        i = CLI_START + 4 * f
        cv2.imwrite(os.path.join(seq, "img1", f"{f:06d}.jpg"), _cli_scene(i))
        for k in (0, 1):
            x, y = _cli_block(k, i)
            dets.append([f, -1, x, y, 120, 90, 0.9, -1, -1, -1])
    det_file = os.path.join(seq, "det", "det.txt")
    np.savetxt(det_file, np.array(dets), delimiter=",")
    outs = [mot_features.extract_sequence(
        create_box_encoder("mars", state_dict=mars_sd, device=d,
                           compute_dtype=torch.float32), seq, det_file)
        for d in (dev, torch.device("cpu"))]
    if not np.array_equal(outs[0][:, :10], outs[1][:, :10]):
        raise SystemExit("parallel: mot_features rows differ card vs CPU")
    return len(outs[0]), float(np.abs(outs[0][:, 10:] - outs[1][:, 10:])
                               .max())


def _par_timed(eng, chunks, dev, tag, profiled):
    """The engine through `tools.bench.bench_streams`: chunks[0] for the
    warm-up, then bench.ROUNDS timed calls on chunks 1 ... ROUNDS (host
    clock, frames staged on the card): aggregate and per-stream frames/s
    (median, min and max of the calls), host syncs, detections and LSAP
    launches (> 0) a frame; if `profiled`, one more call on the last chunk
    under torch.profiler (whose parse of a call's events takes tens of
    seconds). Returns the timed calls' LSAP launches."""
    from deepdish_tpu_torch.tools import bench
    S, F = PAR_STREAMS, PAR_CHUNK
    line, detail = bench.bench_streams(eng, chunks[:bench.ROUNDS + 1],
                                       reps=1)
    states, outs, snaps = detail["states"], detail["outs"], detail["snaps"]
    launches = line["lsap_launches"]
    _check_outputs(outs, snaps, 64, 32)
    if tuple(outs.track_id.shape) != (S, F, 64):
        raise SystemExit(f"parallel: outputs {tuple(outs.track_id.shape)}")
    live = sum(int((st.table.state != 0).sum()) for st in states.streams)
    log(f"[parallel] {tag}: MultiStreamEngine {S} streams x 720p, "
        f"step_chunk({F}), {eng.fs.detector.compute_dtype}, mesh "
        f"{eng.mesh}: warm-up call {line['warmup_s']:.1f} s; "
        f"{bench.ROUNDS} timed calls: aggregate {line['value']:.2f} "
        f"frames/s (min {line['value_min']:.2f}, max "
        f"{line['value_max']:.2f}), {line['per_stream_fps']:.3f} frames/s "
        f"a stream, {line['ms_per_call']:.1f} ms a call, "
        f"{line['host_syncs_per_frame'] * S * F:.1f} host syncs a call "
        f"({line['host_syncs_per_frame']:.2f} a frame), {launches} LSAP "
        f"launches ({line['lsap_launches_per_frame']:.2f} a frame); "
        f"detections a stream-frame {line['dets_per_frame']:.2f}; {live} "
        f"live tracks at the end")
    if launches <= 0:
        raise SystemExit("parallel: the LSAP kernel never launched")
    if not profiled:
        return launches
    t0 = time.perf_counter()
    _profiled(lambda: eng.step_chunk(states, chunks[bench.ROUNDS + 1]),
              S * F, dev, "parallel",
              f"one step_chunk({F}) call of {S} streams, {tag}", PAR_STAGES)
    log(f"[parallel] {tag}: profiled call and its analysis "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_parallel(dev, donors):
    """The parallel engines and the last tools on the card.

    Full width (bench.py's config 5, bf16): MultiStreamEngine on a 1-card
    mesh, 16 streams of the walker scene at 720p (stream s rolled s * 48
    px), `step_chunk` at chunk 8, calibrated random SSD 300 + MARS,
    T = 64, D = 32, G = 64, labels person and car, encode capacity 8, bgsub
    off; aggregate and per-stream frames/s over bench.ROUNDS calls after a
    warm-up (host clock, frames staged on the card), host syncs a call,
    LSAP launches (> 0), and one call under torch.profiler; the same,
    unprofiled, with every COCO label wanted, which loads the trackers.
    Then in
    float32, every COCO label wanted: (a) step_chunk at S = 4, F = 8 equal
    per stream to FrameStep.run_chunk on the card; (b) step equal to
    step_chunk at F = 1; (c) step_chunk_yuv equal to step_chunk on the
    converted frames; (d) S = 2, F = 4 on the card equal to the CPU; (e)
    TemporalChunkEngine on [cuda] * 2 and GridEngine on a 2x2 mesh of the
    card equal per stream to run_chunk; (f) both engines' bgsub
    ValueError. Then multistream_demo (3 streams, --max-frames 8) and
    mot_features (card vs CPU features within 1e-4). `donors` are
    `_par_donors()`. Returns the LSAP launches of the full-width runs."""
    import tempfile

    import torch
    from deepdish_tpu_torch.models import COCO_LABELS
    from deepdish_tpu_torch.ops.colorspace import yuv420_to_rgb_u8
    from deepdish_tpu_torch.parallel import (GridEngine, MultiStreamEngine,
                                             TemporalChunkEngine,
                                             make_grid_mesh, make_mesh)
    from deepdish_tpu_torch.pipeline import FrameStepConfig
    from deepdish_tpu_torch.tools import bench
    t_phase = time.perf_counter()

    # 1. full width, bf16: bench.py's labels, then every COCO label (the
    # random detector's classes are random: 2 of 80 wanted leave the
    # trackers nearly idle)
    t0 = time.perf_counter()
    chunks = [torch.from_numpy(c).to(dev)
              for c in _stream_chunks(PAR_STREAMS, bench.ROUNDS + 2)]
    _sync(dev)
    log(f"[parallel] {len(chunks)} chunks of {PAR_STREAMS} x {PAR_CHUNK} "
        f"720p frames staged on the card in {time.perf_counter() - t0:.1f} "
        f"s ({chunks[0].numel() / 2 ** 20:.0f} MiB each)")
    launches = 0
    log(f"[parallel] frames staged: "
        f"{time.perf_counter() - t_phase:.1f} s")
    for tag, wanted in (("person, car", ["person", "car"]),
                        ("every COCO label", COCO_LABELS)):
        fs = _par_framestep(dev, donors, None, wanted, max(4, len(wanted)))
        eng = MultiStreamEngine(fs, n_streams=PAR_STREAMS, mesh=make_mesh(1))
        launches += _par_timed(eng, chunks, dev, tag,
                               profiled=len(wanted) == 2)
    del chunks, eng, fs
    torch.cuda.empty_cache()

    # 2. float32 checks, every COCO label wanted
    t0 = time.perf_counter()
    n = len(COCO_LABELS)
    fs = _par_framestep(dev, donors, torch.float32, COCO_LABELS, n)
    frames = _stream_chunks(4, 1)[0]
    problems, serr, berr = [], 0.0, 0.0

    def held(tag, got, want, box_px):
        nonlocal serr, berr
        p, se, be = _stream_problems(got, want, tag, box_px)
        problems.extend(p)
        serr, berr = max(serr, se), max(berr, be)

    eng = MultiStreamEngine(fs, n_streams=4, mesh=make_mesh(2, device=dev))
    _, outs, snaps = eng.step_chunk(eng.init_states(), frames)
    for s in range(4):                                         # (a)
        _, o, sn = fs.run_chunk(fs.init_state(), frames[s])
        held(f"(a) stream {s}", (_select(outs, s), _select(snaps, s)),
             (o, sn), 1.0)
    n_dets = [int(v) for v in snaps.valid.sum((1, 2)).cpu()]
    st1 = eng.step(eng.init_states(), frames[:, 0])            # (b)
    stc = eng.step_chunk(eng.init_states(), frames[:, :1])
    same_b = all(torch.equal(a, b[:, 0]) for a, b in
                 zip(st1[1] + st1[2], stc[1] + stc[2]))
    yuv = np.stack([_to_i420(f) for f in frames])              # (c)
    rgb = yuv420_to_rgb_u8(torch.from_numpy(yuv).to(dev), FRAME_H, FRAME_W)
    ya = eng.step_chunk_yuv(eng.init_states(), yuv)
    yb = eng.step_chunk(eng.init_states(), rgb)
    same_c = all(torch.equal(a, b) for a, b in zip(ya[1] + ya[2],
                                                   yb[1] + yb[2]))
    if not (same_b and same_c):
        problems.append(f"(b) step == step_chunk(1): {same_b}; (c) "
                        f"step_chunk_yuv == step_chunk: {same_c}")
    cpu = torch.device("cpu")                                  # (d)
    fs_cpu = _par_framestep(cpu, donors, torch.float32, COCO_LABELS, n)
    runs = []
    for e in (MultiStreamEngine(fs, 2, make_mesh(2, device=dev)),
              MultiStreamEngine(fs_cpu, 2, make_mesh(2, device=cpu))):
        runs.append(e.step_chunk(e.init_states(), frames[:2, :4]))
    for s in range(2):
        held(f"(d) stream {s}", *((_select(r[1], s), _select(r[2], s))
                                  for r in runs), 1.0)
    te = TemporalChunkEngine(fs, mesh=make_mesh(2, "frame", device=dev))
    _, o, sn = te.run_chunk(fs.init_state(), frames[0])        # (e)
    held("(e) temporal", (o, sn), fs.run_chunk(fs.init_state(),
                                               frames[0])[1:], 1.0)
    ge = GridEngine(fs, 2, mesh=make_grid_mesh(2, 2, device=dev))
    _, go, gsn = ge.run_chunk(ge.init_states(), frames[2:])
    for s in range(2):
        held(f"(e) grid stream {s}", (_select(go, s), _select(gsn, s)),
             fs.run_chunk(fs.init_state(), frames[2 + s])[1:], 1.0)
    bg = _par_framestep(dev, donors, torch.float32, COCO_LABELS, n,
                        FrameStepConfig(encode_capacity=8,
                                        background_subtraction=True))
    for make in (lambda: TemporalChunkEngine(                   # (f)
                     bg, mesh=make_mesh(2, "frame", device=dev)),
                 lambda: GridEngine(bg, 2,
                                    mesh=make_grid_mesh(2, 2, device=dev))):
        try:
            make()
            problems.append("(f) an engine took a bgsub FrameStep")
        except ValueError as e:
            if "background" not in str(e):
                problems.append(f"(f) {e}")
    log(f"[parallel] float32 checks at 720p (every COCO label, detections "
        f"a stream {n_dets} over {PAR_CHUNK} frames): (a) step_chunk S=4 F=8 vs "
        f"run_chunk per stream, (b) step vs step_chunk(1) {same_b}, (c) "
        f"step_chunk_yuv vs step_chunk {same_c}, (d) S=2 F=4 card vs CPU, "
        f"(e) TemporalChunkEngine [cuda] * 2 and GridEngine 2x2 vs "
        f"run_chunk, (f) bgsub refused: {len(problems)} problems, max "
        f"|score| error {serr:.3e}, max box error {berr:.3f} px "
        f"({time.perf_counter() - t0:.1f} s)")
    if problems or serr > 1e-4 or min(n_dets) <= 0:
        raise SystemExit(f"parallel: {problems[:8]}")
    del eng, fs, fs_cpu, te, ge, bg

    # 3. the tools
    t0 = time.perf_counter()
    result = _par_demo(dev)
    per = [{k: v for k, v in c.items() if v} for c in result["per_stream"]]
    log(f"[parallel] multistream_demo 3 x 720p --max-frames 8: "
        f"{result['frames']} frames, fps_aggregate {result['fps_aggregate']}"
        f" (first call included), nonzero counters {per} "
        f"({time.perf_counter() - t0:.1f} s)")
    if result["streams"] != 3 or result["frames"] != 3 * PAR_CHUNK:
        raise SystemExit(f"parallel: multistream_demo {result}")
    with tempfile.TemporaryDirectory() as tmp:
        rows, ferr = _par_mot(dev, donors[1], tmp)
    log(f"[parallel] mot_features.extract_sequence, calibrated MARS "
        f"float32: {rows} rows, card vs CPU features max difference "
        f"{ferr:.3e}")
    if rows != 6 or ferr > 1e-4:
        raise SystemExit(f"parallel: mot_features {rows} rows, {ferr}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(f"[parallel] card: {smi.stdout.strip() or 'nvidia-smi: no output'}"
        f"; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 14

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


# ---------------------------------------------------------------- phase 15

BENCH_WANTED = ["person", "car"]   # bench.py's labels
BENCH_STEPS = 200          # --latency samples a leg (bench.py's default)
BENCH_CHUNK = 32           # the chunked mode's --chunk (bench.py's default)
BENCH_FRAMES = 160         # the chunked mode's --frames: 5 chunks
BENCH_REPS = 2             # chained calls a device-resident round
BENCH_STREAMS = 16         # bench.py's config 5
PROFILE_REPS = 5           # profile_components --reps
# keys of a tool's JSON line whose numbers may be 0
BENCH_ZERO_OK = ("encode_overflow_dets", "stage_host_ms_per_frame",
                 "stage_device_ms_per_frame")


def _bench_problems(line, key=None):
    """The numbers of a tool's JSON line that are not finite, or not
    positive where they must be (every number but those under
    BENCH_ZERO_OK)."""
    if isinstance(line, dict):
        return [p for k, v in line.items()
                for p in _bench_problems(v, key if key else k)]
    if isinstance(line, (list, tuple)):
        return [p for v in line for p in _bench_problems(v, key)]
    if isinstance(line, bool) or not isinstance(line, (int, float)):
        return []
    if not np.isfinite(line) or (line < 0 or
                                 (line == 0 and key not in BENCH_ZERO_OK)):
        return [f"{key} = {line}"]
    return []


def phase_bench(dev, donors):
    """The port's measuring tools in process at full width, bf16, on
    bench.py's FrameStep with the calibrated random SSD 300 + MARS
    (`_par_framestep`: T = 64, D = 32, G = 64, labels person and car,
    encode capacity 8), each through its `main` with that FrameStep given:
    tools.bench --latency, the chunked mode on synthetic frames and (where
    the native frame loader builds) on an mp4, --streams 16 and (with the
    loader) --streams 16 --e2e, then tools.profile_components. Each prints
    its JSON line; every number must be finite (timings positive), and
    every bench mode must have launched the LSAP kernel. Whether the
    loader builds is checked before any run (`bench.loader_problem`).
    `donors` are phase 13's `_par_donors()`. Returns the LSAP launches of
    the runs and the chunked synthetic run's `value_window` (frames/s)."""
    import tempfile

    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.tools import bench, profile_components
    t_phase = time.perf_counter()
    fs = _par_framestep(dev, donors, None, BENCH_WANTED, 4)
    chunked = ["--chunk", str(BENCH_CHUNK), "--frames", str(BENCH_FRAMES),
               "--reps", str(BENCH_REPS)]
    streams = ["--streams", str(BENCH_STREAMS), "--stream-chunk",
               str(PAR_CHUNK), "--reps", "1"]
    runs = [("latency", ["--latency", "--steps", str(BENCH_STEPS)]),
            ("chunked, synthetic", chunked + ["--synthetic"]),
            ("streams", streams)]
    missing = bench.loader_problem()
    if missing is None:
        runs += [("chunked, mp4", chunked),
                 ("streams, e2e", streams + ["--e2e", "--frames",
                                             str(4 * PAR_CHUNK)])]
    else:
        log(f"[bench] the mp4 source is not run: {missing}")
    launches, problems, fps = 0, [], None
    with tempfile.TemporaryDirectory() as tmp:
        for tag, argv in runs:
            t0 = time.perf_counter()
            line = bench.main(argv + ["--video-dir", tmp],
                              framestep=fs)
            if tag == "chunked, synthetic":
                fps = line["value_window"]
            launches += line["lsap_launches"]
            p = _bench_problems(line)
            if line["lsap_launches"] <= 0:
                p.append("the LSAP kernel never launched")
            problems += [f"{tag}: {m}" for m in p]
            log(f"[bench] {tag}: {time.perf_counter() - t0:.1f} s, "
                f"{line['value']:.3f} {line['unit']}, "
                f"{line['frames']} frames, "
                f"{line['host_syncs_per_frame']:.2f} host syncs and "
                f"{line['lsap_launches_per_frame']:.3f} LSAP launches a "
                f"frame, {line['dets_per_frame']:.2f} detections a frame")
    t0 = time.perf_counter()
    lsap.launches = 0
    line = profile_components.main(
        ["--chunk", str(BENCH_CHUNK), "--reps", str(PROFILE_REPS)],
        framestep=fs)
    launches += lsap.launches
    problems += [f"profile_components: {m}" for m in _bench_problems(line)]
    if set(line["figures_ms_per_frame"]) != set(profile_components.FIGURES):
        problems.append(f"profile_components: figures "
                        f"{sorted(line['figures_ms_per_frame'])}")
    log(f"[bench] profile_components: {time.perf_counter() - t0:.1f} s, "
        f"{lsap.launches} LSAP launches; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise SystemExit(f"bench: {problems[:8]}")
    return launches, fps


# ---------------------------------------------------------------- phase 16

TOOLS_CHUNK = 32           # flops_report's --chunk (the JAX tool's default)
TOOLS_ENC_CAP = 8
MICRO_REPS = 4             # profile_micro --reps
# flops_report's families: (label, --model, --quantized); "QSSD" is the
# full-integer SSD file the phase writes
TOOLS_FAMILIES = (("SSD + MARS", "ssd_mobilenet", False),
                  ("YOLOv5s", "yolov5s", False), ("YOLOv3", "yolov3", False),
                  ("EfficientDet-Lite0", "efficientdet-lite0", False),
                  ("Faster R-CNN", "faster_rcnn", False),
                  ("quantized SSD", "QSSD", True))


def _zoo_files(tmp):
    """The zoo battery's artifacts, written as phases 11 and 12 write them:
    a float SSD-MobileNetV1 with the postprocess op and a float MARS
    (`written_tflite`, calibrated donors), and their full-integer
    counterparts (`QuantGraph`: `quant_ssd_donor` quantized on the walker
    scene, the MARS donor on its calibration images). Returns
    {name: path}."""
    import torch
    from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
    from deepdish_tpu_torch.models.ssd_mobilenet import (INPUT_SIZE,
                                                         SSDMobileNetV1)
    ssd = SSDMobileNetV1()
    _calibrated_init(ssd, torch.Generator().manual_seed(SEED),
                     _calibration_images(INPUT_SIZE, INPUT_SIZE))
    mars = MarsNet()
    _calibrated_init(mars, torch.Generator().manual_seed(SEED + 1),
                     _calibration_images(*INPUT_SHAPE[:2]))
    files = {
        "ssd_mobilenet_v1_coco_pp.tflite": written_tflite(
            ssd, (1, INPUT_SIZE, INPUT_SIZE, 3), _ssd_pp_options()),
        "mars-small128.tflite": written_tflite(mars, (1,) + INPUT_SHAPE),
        "ssd_mobilenet_v1_coco_quant_postprocess.tflite": _quant_ssd_tflite(),
        "mars-little128_int8.tflite": quantized_mars_graph(
            mars, _calibration_images(*INPUT_SHAPE[:2]).numpy()).tflite()}
    paths = {}
    for name, data in files.items():
        paths[name] = f"{tmp}/{name}"
        with open(paths[name], "wb") as f:
            f.write(data)
    return paths


def _quant_ssd_tflite():
    """Phase 12's full-integer SSD-MobileNetV1 file (`quant_ssd_donor`,
    quantized on QUANT_CHUNK frames of the walker scene), as bytes."""
    import torch
    from deepdish_tpu_torch.models.preprocess import resize_bilinear_mxu
    from deepdish_tpu_torch.models.ssd_mobilenet import INPUT_SIZE
    scene = np.ascontiguousarray(np.stack(
        [_cli_scene(CLI_START + 3 * k)
         for k in range(QUANT_CHUNK)])[..., ::-1])
    resized = resize_bilinear_mxu(torch.from_numpy(scene), INPUT_SIZE,
                                  INPUT_SIZE, torch.float32)
    return quantized_ssd_graph(quant_ssd_donor(), INPUT_SIZE, resized.numpy(),
                               _ssd_pp_options()).tflite()


def _mp4_problem(tmp):
    """None when this machine's cv2 writes the zoo battery's drive video
    and reads its 16 frames back; else what failed, in words."""
    from deepdish_tpu_torch.tools import zoo_validate
    try:
        import cv2
        path = f"{tmp}/probe.mp4"
        zoo_validate.write_drive_video(path)
        cap = cv2.VideoCapture(path)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
    except Exception as e:              # cv2 missing or broken
        return f"cv2 cannot write and read an mp4 ({e})"
    return None if n == 16 else f"cv2 read {n} of the 16 frames it wrote"


def _tools_flops(dev, fps, qssd):
    """flops_report per family: the card's count at TOOLS_CHUNK frames must
    be TOOLS_CHUNK times the CPU's at 1 frame, stage by stage (exact
    integers). SSD + MARS also prints its MFU at `fps`. Returns
    problems."""
    import torch
    from deepdish_tpu_torch.tools import flops_report
    problems = []
    for label, model, quantized in TOOLS_FAMILIES:
        argv = ["--model", qssd if model == "QSSD" else model,
                "--enc-cap", str(TOOLS_ENC_CAP)] + \
            (["--quantized"] if quantized else [])
        t0 = time.perf_counter()
        card = flops_report.main(
            argv + ["--chunk", str(TOOLS_CHUNK)]
            + (["--fps", str(fps)] if model == "ssd_mobilenet" else []))
        cpu = flops_report.main(argv + ["--chunk", "1", "--device", "cpu"])
        torch.cuda.synchronize()
        stages = card["stage_flops_per_dispatch"]
        equal = stages == {k: TOOLS_CHUNK * v for k, v in
                           cpu["stage_flops_per_dispatch"].items()}
        if not equal or card["flops_per_dispatch"] <= 0 or \
                sum(stages.values()) != card["flops_per_dispatch"]:
            problems.append(f"{label}: card {stages} at {TOOLS_CHUNK} "
                            f"frames, CPU {cpu['stage_flops_per_dispatch']} "
                            f"at 1")
        log(f"[tools] flops {label}: {card['value']:.4f} GFLOP a frame ("
            + ", ".join(f"{k} {v:.4f}"
                        for k, v in card["gflop_per_frame"].items())
            + f"); card at {TOOLS_CHUNK} frames == {TOOLS_CHUNK} x CPU at 1, "
            f"stage by stage: {equal} ({time.perf_counter() - t0:.1f} s)")
    return problems


def _tools_zoo(dev, paths, tmp):
    """zoo_validate on each written file on the card and on the CPU: exit
    0, parse / anchors / convert / drive PASS (the encoder files: convert),
    integer / detect / embed SKIP without tensorflow, and the card's steps
    equal to the CPU's. The drive step runs only where cv2 writes and
    reads back an mp4 (checked first; else a line says so and
    --skip-drive is passed). Returns problems."""
    from deepdish_tpu_torch.tools import zoo_validate
    missing = _mp4_problem(tmp)
    extra = []
    if missing is not None:
        log(f"[tools] zoo_validate's drive step is not run: {missing}")
        extra = ["--skip-drive"]
    try:
        import tensorflow  # noqa: F401
        has_tf = True
    except ImportError:
        has_tf = False
    problems = []
    for name, path in paths.items():
        encoder = "mars" in name
        must_pass = ["convert"] if encoder else \
            ["parse", "anchors", "convert"] + ([] if extra else ["drive"])
        must_skip = [] if has_tf else (
            ["embed"] if encoder else ["integer", "detect"])
        got = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            rc = zoo_validate.main([path, "--device", d] + extra)
            got[d] = (rc, {s: st for s, st, _ in zoo_validate.RESULTS})
            log(f"[tools] zoo_validate {name} --device {d}: exit {rc}, "
                f"{got[d][1]} ({time.perf_counter() - t0:.1f} s)")
        rc, steps = got["cuda"]
        if rc != 0 or got["cpu"] != got["cuda"] or \
                any(steps.get(s) != "PASS" for s in must_pass) or \
                any(steps.get(s) != "SKIP" for s in must_skip):
            problems.append(f"{name}: card {got['cuda']}, CPU {got['cpu']}")
    return problems


def phase_tools(dev, fps):
    """The port's last measuring and validation tools through their `main`:
    flops_report for SSD + MARS, YOLOv5s, YOLOv3, EfficientDet-Lite0,
    Faster R-CNN and the quantized SSD (the card's count equal to the
    CPU's; SSD + MARS's MFU at `fps`, phase 15's chunked `_window` rate),
    and the dsconv kernel's reported work equal to its plain version's
    count; profile_micro's three groups at the JAX tool's shapes (the LSAP
    kernel's assignment equal to the plain version's); coldstart_probe's
    two legs in fresh processes (the cold one builds into an empty
    directory; equal track ids); zoo_validate on the written files
    (`_zoo_files`) on the card and on the CPU. Its runs count no launches
    of the main path: flops_report replays the tracker, and the others
    time or validate."""
    import tempfile

    import torch
    from deepdish_tpu_torch.ops.dsconv import fused_dsconv
    from deepdish_tpu_torch.tools import (coldstart_probe, profile_micro,
                                          probe_dsconv)
    from deepdish_tpu_torch.utils import flops
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = _zoo_files(tmp)
        log(f"[tools] {len(paths)} zoo files written in "
            f"{time.perf_counter() - t0:.1f} s")
        qssd = paths["ssd_mobilenet_v1_coco_quant_postprocess.tflite"]
        problems = _tools_flops(dev, fps, qssd)

        # the dsconv kernel reports its work: card (kernel) == CPU (plain)
        _, h, w, cin, cout, s = probe_dsconv.STAGES[-1]
        x = torch.from_numpy(np.random.RandomState(SEED).standard_normal(
            (2, h, w, cin)).astype(np.float32))
        weights = probe_dsconv.block_weights(np.random.RandomState(SEED),
                                             cin, cout, "cpu", torch.float32)
        counts = {}
        for d, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            with torch.inference_mode(), flops.Count() as c:
                fused_dsconv(x.to(d, dt), *(t.to(d) for t in weights),
                             stride=s)
            counts[d] = c.by_op()
        log(f"[tools] flops of fused_dsconv at ds13, batch 2: card (kernel)"
            f" {counts['cuda']}, CPU (plain) {counts['cpu']}")
        if sum(counts["cuda"].values()) != sum(counts["cpu"].values()) or \
                counts["cuda"].get(flops.REPORTED) != sum(
                    counts["cpu"].values()):
            problems.append(f"dsconv flops: {counts}")

        t0 = time.perf_counter()
        micro = profile_micro.main(["--reps", str(MICRO_REPS)])
        if micro["lsap_kernel_equal"] is not True:
            problems.append("profile_micro: the LSAP kernel's assignment "
                            "differs from the plain version's")
        for row in micro["legs"]:
            ms = [row["host_ms"], row["device_ms"]]
            if not all(np.isfinite(v) and v > 0 for v in ms) or \
                    not row["host_syncs"] >= 0:
                problems.append(f"profile_micro: {row}")
        log(f"[tools] profile_micro: {len(micro['legs'])} legs in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):     # its line holds 2 x 2048 ids
            cold = coldstart_probe.main([])
        log("\n".join(out.getvalue().splitlines()[:-1]))
        legs = cold["legs"]
        if not cold["track_ids_equal"] or \
                legs["cold"]["seconds"]["kernel_build"] <= 0 or \
                not legs["cold"]["build_dir_files"]:
            problems.append(f"coldstart: ids equal "
                            f"{cold['track_ids_equal']}, cold leg "
                            f"{legs['cold']['seconds']}, built "
                            f"{legs['cold']['build_dir_files']}")
        log(f"[tools] coldstart_probe: {time.perf_counter() - t0:.1f} s; "
            f"track ids equal {cold['track_ids_equal']} "
            f"({sum(i >= 0 for f in legs['fresh']['track_ids'] for i in f)}"
            f" live); cold leg built {legs['cold']['build_dir_files']}")

        problems += _tools_zoo(dev, paths, tmp)
    log(f"[tools] phase {time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise SystemExit(f"tools: {problems[:8]}")


# ---------------------------------------------------------------- phase 17

PROBE_ROUNDS = 2           # timed rounds of every probe (the tools': 3-4)
PROBE_MARS_REPS = 2        # profile_mars_int8's calls a round (32; fused 16)
PROBE_AB_REPS = 2          # round4_ab_interleaved's calls a round (16)


def _tool_run(mod, argv, **seams):
    """mod.main(argv, **seams) with its output captured and logged line by
    line; returns (exit code, its last line's JSON object)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv, **seams)
    lines = out.getvalue().strip().splitlines()
    name = mod.__name__.rsplit(".", 1)[1]
    for line in lines:
        log(f"[probes] {name}: {line}")
    log(f"[probes] {' '.join([name] + argv)}: exit {rc} in "
        f"{time.perf_counter() - t0:.1f} s")
    return rc, json.loads(lines[-1])


def _numbers(tree, where):
    """The numbers of a JSON subtree that are not finite and positive."""
    return [f"{where}: {p}" for p in _bench_problems(tree)]


def phase_probes(dev, donors):
    """The six last tools through their `main` on the card at the JAX
    tools' shapes, with PROBE_ROUNDS rounds (and fewer calls a round for
    the MARS and fused legs): probe_int8 (4096^2 and the three convs; the
    int8 legs card == CPU exactly on a seeded input), profile_mars_int8
    (MARS at batch 1024 in bf16 and int8 with impl dot and conv, whose
    features must be bit-equal; the fused step at chunk 32, 720p, encode
    capacity 32 and 8), round4_ab_interleaved with --mars-bisect
    --mars-cap32 --det-int8 and --weights on phase 12's full-integer SSD
    file, probe_grouped_conv (the packed layout per crop == the base conv
    within the reorder bound), profile_mars_width (Wide(32, 64, 128) ==
    MarsNet); no rate above the H100's dense peak (the tools exit 1 on
    one), every timing finite and positive, the fused legs' LSAP launches
    > 0. Then decode_probe where the native frame loader loads: where
    `bench.loader_problem` names OpenCV, a line says so and that one run
    is skipped. The fused legs run on the donors' weights (phase 13's).
    Returns the LSAP launches of the fused legs."""
    import tempfile

    from deepdish_tpu_torch.tools import (bench, decode_probe,
                                          probe_grouped_conv, probe_int8,
                                          profile_mars_int8,
                                          profile_mars_width,
                                          round4_ab_interleaved)
    t_phase = time.perf_counter()
    problems, launches = [], 0
    rc, line = _tool_run(probe_int8, [], rounds=PROBE_ROUNDS)
    if rc or line["int8_card_equals_cpu"] is not True or line["over_peak"]:
        problems.append(f"probe_int8: exit {rc}, card == CPU "
                        f"{line['int8_card_equals_cpu']}, over the peak "
                        f"{line['over_peak']}")
    problems += _numbers([{k: v for k, v in r.items() if k != "shape"}
                          for r in line["legs"]], "probe_int8")

    rc, line = _tool_run(profile_mars_int8, [], rounds=PROBE_ROUNDS,
                         reps=PROBE_MARS_REPS, fused_reps=PROBE_MARS_REPS,
                         donors=donors)
    launches += line["lsap_launches"]
    if rc or not line["dot_conv_features_equal"] or \
            line["lsap_launches"] <= 0:
        problems.append(f"profile_mars_int8: exit {rc}, dot == conv "
                        f"{line['dot_conv_features_equal']}, LSAP launches "
                        f"{line['lsap_launches']}")
    problems += _numbers([line["standalone"], line["ratios"]] + [
        g["legs"] for g in line["fused"].values()], "profile_mars_int8")

    with tempfile.TemporaryDirectory() as tmp:
        qssd = f"{tmp}/ssd_mobilenet_v1_coco_quant_postprocess.tflite"
        with open(qssd, "wb") as f:
            f.write(_quant_ssd_tflite())
        rc, line = _tool_run(
            round4_ab_interleaved, ["--weights", qssd, "--mars-bisect",
                                    "--mars-cap32", "--det-int8"],
            rounds=PROBE_ROUNDS, reps=PROBE_AB_REPS, donors=donors)
    launches += line["lsap_launches"]
    if rc or line["lsap_launches"] <= 0 or len(line["modes"]) != 4:
        problems.append(f"round4_ab_interleaved: exit {rc}, modes "
                        f"{line['modes']}, LSAP launches "
                        f"{line['lsap_launches']}")
    problems += _numbers(
        [line["ratios"], line["weights"]["legs"], line["mars_cap32"]["legs"],
         line["mars_bisect"]["standalone"], line["mars_bisect"]["crop"],
         line["mars_bisect"]["fused_cap8"]["legs"]]
        + [g["legs"] for g in line["det_int8"].values()],
        "round4_ab_interleaved")

    rc, line = _tool_run(probe_grouped_conv,
                         ["--rounds", str(PROBE_ROUNDS)])
    if rc or not line["packed_identity_holds"] or line["over_peak"]:
        excess = [r["packed_identity_excess"] for r in line["shapes"]]
        problems.append(f"probe_grouped_conv: exit {rc}, identity excess "
                        f"{excess}, over the peak {line['over_peak']}")
    problems += _numbers([r["legs"] for r in line["shapes"]],
                         "probe_grouped_conv")

    rc, line = _tool_run(profile_mars_width, [], rounds=PROBE_ROUNDS)
    if rc or not line["wide_equals_marsnet"]:
        problems.append(f"profile_mars_width: exit {rc}, Wide == MarsNet "
                        f"{line['wide_equals_marsnet']}")
    problems += _numbers([{k: r[k] for k in ("ms_per_batch", "us_per_crop",
                                             "vs_stock")}
                          for r in line["variants"]], "profile_mars_width")

    missing = bench.loader_problem()
    if missing is not None and "opencv" in missing.lower():
        log(f"[probes] decode_probe is not run: {missing}")
    else:
        rc, line = _tool_run(decode_probe, [])
        if rc:
            problems.append(f"decode_probe: exit {rc}")
        problems += _numbers([line["decode_only_fps"],
                              line["striped_fps_by_workers"]],
                             "decode_probe")
    log(f"[probes] {launches} LSAP launches in the fused legs; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise SystemExit(f"probes: {problems[:8]}")
    return launches


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
    # Faster R-CNN, the tflite phase's CLI, the quantized phase's CLIs, the
    # multi-stream engine at full width, the measuring tools and the
    # probes' fused legs
    entry["launches"] += timed("families", phase_families, dev)
    entry["launches"] += timed("cvat", phase_cvat, dev)
    entry["launches"] += timed("frcnn", phase_frcnn, dev)
    entry["launches"] += timed("tflite", phase_tflite, dev)
    entry["launches"] += timed("quantized", phase_quantized, dev)
    donors = timed("donors", _par_donors)       # phases 13, 15 and 17
    entry["launches"] += timed("parallel", phase_parallel, dev, donors)
    by_stride = timed("probe", phase_probe, dev)
    launches, fps = timed("bench", phase_bench, dev, donors)
    entry["launches"] += launches
    timed("tools", phase_tools, dev, fps)
    entry["launches"] += timed("probes", phase_probes, dev, donors)
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
