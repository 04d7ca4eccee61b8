#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (deepdish_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100, sm_90a), nvcc and scipy. Phases, each fatal on
failure:

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
             every frame finite, its objd and e2e ms/frame; and
             `--model scripted:bright` on the card (LSAP launches, reset
             before and read after, > 0) and on the CPU, whose counters
             must both equal the crossings the scene implies;
  7. probe   the ported dsconv probe (deepdish_tpu_torch.tools.probe_dsconv)
             at full width: batch 32, 6 layers, all 9 stages, 2 rounds of 4;
             the dsconv launch counts are reset before and read after, and
             both strides must have launched;
  8. report  the `kernels` JSON line, the card's name and power limit, and
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
            kernel_ms = min(kernel_ms,
                            _time_cuda(lambda: dsconv.fused(*args, s), 20))
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
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"[dsconv]   {label}: kernel {kernel_ms:.5f} ms, plain "
                f"torch {plain_ms:.5f} ms (the timed entry of stride {s})")
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

def _framestep(dev, frame_shape, compute_dtype=None, step_cfg=None):
    import torch
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import (COCO_LABELS, create_box_encoder,
                                           create_detector)
    from deepdish_tpu_torch.pipeline import FrameStep, FrameStepConfig
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


def profile_step(fs, frames, dev, tag="slice", state=None):
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
    host = dict.fromkeys(STAGES, 0.0)
    device = dict.fromkeys(STAGES, 0.0)
    for e in prof.events():
        if e.name in host and e.device_type.name == "CPU":
            host[e.name] += e.cpu_time_total / n / 1e3
            device[e.name] += e.device_time_total / n / 1e3
    log(f"[{tag}] stage split of step (torch.profiler ranges, ms/frame "
        "host / device): " + ", ".join(
            f"{k} {host[k]:.3f} / {device[k]:.3f}" for k in STAGES))
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


def _run_cli(argv, n_frames):
    """deepdish_tpu_torch.pipeline.main.amain with the scene through
    Pipeline._open_capture. Returns (pipeline, per-frame timing ms by
    label, frames seen by the frame step, non-finite frames)."""
    import asyncio

    from deepdish_tpu_torch.pipeline import main as cli
    from deepdish_tpu_torch.pipeline.elements import TimingInfo
    from deepdish_tpu_torch.pipeline.runtime import Pipeline
    seen = {"timing": {}, "frames": 0, "bad": 0}

    class SmokePipeline(Pipeline):
        def _open_capture(self, source):
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

    phase_build()
    entry = phase_kernel(dev)
    ds_entries = phase_dsconv(dev)
    phase_tracker(dev)
    phase_reference(dev)
    launches, _ = phase_slice(dev)
    entry["launches"] = launches
    phase_cli(dev)
    by_stride = phase_probe(dev)
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
