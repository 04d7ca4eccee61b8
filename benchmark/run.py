"""One run of one benchmark cell of deepdish_tpu_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's configuration on the card with weights made from the
seed, warms up the cell's own shapes, runs its traffic through the port's
`MultiStreamEngine.step_chunk_yuv` for `--seconds` (a closed loop, one
call in flight), compares what the window produced with the plain
reference (`reference/`), and prints one JSON line last: the end-to-end
metrics with `--trace 0`, the per-layer metrics with `--trace 1` (from a
`torch.profiler` trace of the window). Exits non-zero without a result
when the cell's cards are missing, and when JAX, flax or the JAX package
were loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, scene, spec, stats, system, tracing  # noqa: E402
from harness import weights as W  # noqa: E402
from harness import window as win_mod  # noqa: E402
from harness.flops import step_flops  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "deepdish_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def sampled_calls(rng: np.random.Generator, share: float, limit=100000):
    """Call indices to check: each with probability `share`, and one of
    the first three always."""
    calls = set(np.nonzero(rng.random(limit) < share)[0].tolist())
    calls.add(int(rng.integers(0, 3)))
    return calls


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, control: bool = False) -> dict:
    """One run of `cell` on `device`; returns the result's fields (and,
    with `control`, the control's readings)."""
    cfg, tr = cell.config, cell.traffic
    fam = spec.family(cfg)
    dtype = getattr(torch, cfg["precision"]["networks"])
    with torch.inference_mode(False), torch.no_grad():
        waves = scene.scene(tr, seed, device)
        traffic = scene.make(tr, seed, device, waves)
        sd_det, ref_det = fam.make_weights(cfg, tr, seed, device, waves,
                                           dtype)
        sd_mars, ref_mars = W.make_mars(
            seed, device, W.calibration_frames(tr, waves), dtype)
        del waves
    sysm = system.build(cell, sd_det, sd_mars, device, dtype, fam)
    system.warm_lsap(device)
    win_mod.warm(sysm, traffic, int(tr["warm_calls"]), device)
    rng = np.random.default_rng(scene.seed_int(seed, 13))
    streams = sorted(rng.choice(int(tr["streams"]),
                                int(tr["check_streams"]),
                                replace=False).tolist())
    sysm.recorder.sampled = sampled_calls(rng, float(tr["check_share"]))
    labels, line = list(tr["labels"]), check.countline(tr)
    countings = [system.counting_state(labels, line)
                 for _ in range(int(tr["streams"]))]
    setup_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        # the serving peak: from the window's start, set-up's left out
        torch.cuda.reset_peak_memory_stats(device)
    prof = tracing.profiler() if trace else None
    if prof is not None:
        prof.start()
    win = win_mod.run(sysm, traffic, seconds, countings, system.counters,
                      device)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    res = {"seconds": win.seconds, "calls": win.calls, "frames": win.frames,
           "setup_s": setup_s, "memory_peak_bytes": int(peak),
           "forbidden": found, "counters": win.counters,
           "latency_ms": win_mod.frame_latencies_ms(
               win, int(tr["streams"]) * int(tr["frames_per_call"]))}
    if prof is not None:
        res["trace"] = tracing.reduce(prof)
        del prof
    recorder = sysm.recorder
    del sysm
    if cuda:
        torch.cuda.empty_cache()
    res["crossings"] = sum(c.poscount[k] + c.negcount[k]
                           for c in countings for k in c.poscount)
    res["detections"] = sum(int(d.valid.sum()) for c in range(win.calls)
                            for d in recorder.calls[c]["dets"])
    calls = sorted(c for c in recorder.sampled if c < win.calls)
    checker = fam.Checker(cfg, ref_det, device)
    ctrl = None
    if control:
        from harness.control import fp8_copy
        ctrl = (fp8_copy(ref_det), fp8_copy(ref_mars))
    with torch.inference_mode():
        res["numbers"] = check.compare(cell, fam, checker, ref_mars,
                                       traffic, win, recorder, countings,
                                       streams, calls, device, ctrl)
    res["checked"] = {"streams": streams, "calls": calls}
    if trace:
        res["flops"] = step_flops(fam, cfg, int(tr["height"]),
                                  int(tr["width"]))
    return res


def end_to_end(cell, res) -> dict:
    values = {
        "fps": stats.rate(res["frames"], res["seconds"]),
        "latency_ms_p90": stats.percentiles(res["latency_ms"])["p90"],
        "setup_s": res["setup_s"],
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(cell, res) -> dict:
    """The cell's per-layer metrics that have something to read. A
    metric's `read(ctx)` gets: frames, calls, window_s, counters (the
    port's, over the window), trace (`tracing.reduce`), flops
    (`flops.step_flops`), config, traffic."""
    ctx = dict(frames=res["frames"], calls=res["calls"],
                  window_s=res["seconds"], counters=res["counters"],
                  trace=res["trace"], flops=res["flops"], config=cell.config,
                  traffic=cell.traffic)
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return done.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, spec.benchmark_file())
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T0)
    found = sorted(set(res["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    limits = cell.config["limits"]
    correct, rows = check.judge(res["numbers"], limits)
    line = {
        "correct": bool(correct),
        "attempted": res["frames"],
        "failed": 0,
        "metrics": (per_layer(cell, res) if args.trace
                    else end_to_end(cell, res)),
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": res["memory_peak_bytes"]},
    }
    if args.trace:
        t = res["trace"]
        line["device"].update(busy_s=t["busy_s"], window_s=res["seconds"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    print(f"card: {power_limit()}; calls {res['calls']}, frames "
          f"{res['frames']}, window {res['seconds']:.3f} s, detections "
          f"{res['detections']}, crossings {res['crossings']}; checked "
          f"streams {res['checked']['streams']} calls "
          f"{res['checked']['calls']}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
