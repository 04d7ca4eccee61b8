"""Readings from which the comparison's limits are set, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <n> ...] \
        [--faults <name> ...] [--fault-seeds <n> ...] \
        [--fault-seconds <s>]

In this one process, for each seed of `--seeds` one run of the cell as
`run.py` makes it (set-up, a window of `--seconds`, the comparison), and
one JSON line: the program's numbers and whether they are correct. For
the seeds of `--control-seeds` the line also has the control's numbers
(`harness/control.py`: the reference's networks in float8 e4m3 put in the
program's place) and the control's verdict by the same limits, which has
to be false. Then for each fault of `--faults` (`harness/faults.py`;
`all`: every fault the cell can have) and each of `--fault-seeds`, a run
of `--fault-seconds` with that fault planted in the program, whose
verdict has to be false. The last line sums up: `ok` is true when every
sound run is correct and every control and fault run is not. The
benchmark's own runs never run the control or a fault.
"""
import json
import sys
import time

import run  # noqa: E402  (sets the import path)
import torch  # noqa: E402
from harness import faults, spec  # noqa: E402


def one(cell, seed, seconds, device, control=False):
    """(JSON line, program correct, control correct or None)."""
    t0 = time.perf_counter()
    res = run.run_cell(cell, seed, seconds, False, device, t0,
                       control=control)
    nums = dict(res["numbers"])
    ctrl = nums.pop("control", None)
    limits = cell.config["limits"]
    ok, _rows = run.check.judge(nums, limits)
    ctrl_ok = run.check.judge(ctrl, limits)[0] if ctrl else None
    line = {
        "workload": cell.name, "seed": seed, "correct": ok,
        "program": nums, "control": ctrl, "control_correct": ctrl_ok,
        "fps": run.stats.rate(res["frames"], res["seconds"]),
        "calls": res["calls"], "setup_s": res["setup_s"],
        "detections_per_frame": res["detections"] / res["frames"],
        "crossings": res["crossings"], "counters": res["counters"],
        "memory_peak_bytes": res["memory_peak_bytes"],
        "checked": res["checked"],
        "compare_s": time.perf_counter() - t0 - res["setup_s"]
        - res["seconds"]}
    torch.cuda.empty_cache()
    return line, ok, ctrl_ok


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=())
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--faults", nargs="*", default=())
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=())
    ap.add_argument("--fault-seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, spec.benchmark_file())
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    names = (faults.for_cell(cell) if list(args.faults) == ["all"]
             else list(args.faults))
    bad = []
    for seed in args.seeds:
        line, ok, ctrl_ok = one(cell, seed, args.seconds, device,
                                control=seed in args.control_seeds)
        print(json.dumps(line), flush=True)
        if not ok or ctrl_ok:
            bad.append(("seed", seed))
    for name in names:
        for seed in args.fault_seeds:
            mend = faults.plant(name)
            try:
                line, ok, _ = one(cell, seed, args.fault_seconds, device)
            finally:
                mend()
            print(json.dumps(dict(line, fault=name)), flush=True)
            if ok:
                bad.append((name, seed))
    print(json.dumps({"workload": cell.name, "ok": not bad, "bad": bad}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
