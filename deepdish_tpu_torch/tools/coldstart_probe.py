"""Time to the first result of the port in a fresh process, split.

Port of the repository's tools/coldstart_probe.py. The JAX tool measures
what a serialized executable saves over the first compile; the port's
counterpart of a compile cache is the hashed kernel library in
`deepdish_tpu_torch/_build/` (kernels/_build.py), so each leg here runs
in a fresh Python process:

  --fresh  the build directory as it stands (a library built earlier is
           loaded, not rebuilt);
  --cold   an empty temporary build directory (`kernels._build.BUILD_DIR`
           pointed at it inside the child), so nvcc builds every kernel
           the chunk path launches.

Each leg reports, in seconds: `import` (torch and the port), `cuda_context`
(the first CUDA call), `kernel_build` (loading, or building, each kernel of
the chunk path: 0 on the CPU, which launches none), `model_build`
(bench.py's FrameStep, random seeded SSD-MobileNetV1 + MARS),
`first_chunk` (the first `run_chunk` of --chunk frames at --height x
--width, ending in a host read of its track ids), `second_chunk` (the
same call again, from a fresh state) and `first_result` (from the child's
start to the first chunk's track ids), beside `process_s`, the parent's
clock around the whole child (interpreter start included), and the first
chunk's track ids. Without a leg flag both legs run, one after the other.

  python -m deepdish_tpu_torch.tools.coldstart_probe [--fresh | --cold] \
      [--chunk 32] [--height 720] [--width 1280] [--device cuda]

Prints each leg's split, then one JSON line last with both legs,
whether their track ids agree, and the bench's `platform` and `device`
keys.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# kernels the chunk path launches: the LSAP solve of every association
# stage (kernels/lsap.py); the dsconv kernel is not on it
CHUNK_KERNELS = ("lsap",)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LEG_TIMEOUT_S = 900        # a leg's process, nvcc build included
TERMS = ("import", "cuda_context", "kernel_build", "model_build",
         "first_chunk", "second_chunk", "first_result")


def child(args, t_start):
    """One leg in this (fresh) process; returns its JSON dict."""
    t0 = time.perf_counter()
    import numpy as np
    import torch

    from deepdish_tpu_torch.kernels import _build
    from deepdish_tpu_torch.tools import bench
    s = {"import": time.perf_counter() - t0}
    from deepdish_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    s["cuda_context"] = s["kernel_build"] = 0.0    # none on the CPU
    if cuda:
        t0 = time.perf_counter()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        s["cuda_context"] = time.perf_counter() - t0
    tmp = None
    if args.leg == "cold":
        tmp = tempfile.TemporaryDirectory()
        _build.BUILD_DIR = tmp.name
    if cuda:
        t0 = time.perf_counter()
        for name in CHUNK_KERNELS:
            _build.load(name)
        s["kernel_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = bench.build_framestep(device=dev, height=args.height,
                               width=args.width)
    s["model_build"] = time.perf_counter() - t0
    frames = np.random.RandomState(0).randint(
        0, 255, (args.chunk, args.height, args.width, 3)).astype(np.uint8)
    ids = []
    for term in ("first_chunk", "second_chunk"):
        t0 = time.perf_counter()
        _, outs, _ = fs.run_chunk(fs.init_state(), frames)
        ids.append(bench.read(dev, outs.track_id))
        s[term] = time.perf_counter() - t0
        if term == "first_chunk":
            s["first_result"] = time.perf_counter() - t_start
    if tmp is not None:
        libs = sorted(os.listdir(tmp.name))
        tmp.cleanup()
    else:
        libs = None
    return {"leg": args.leg, "seconds": s,
            "kernels": list(CHUNK_KERNELS) if cuda else [],
            "kernel_build_note": (None if cuda else
                                  "0 on the CPU: no kernel is launched"),
            "build_dir_files": libs,
            "track_ids": ids[0].tolist(),
            "second_ids_equal": bool(np.array_equal(ids[0], ids[1]))}


def run_leg(leg, args):
    """The leg in a fresh subprocess: its JSON dict, with `process_s`."""
    argv = [sys.executable, "-m", "deepdish_tpu_torch.tools.coldstart_probe",
            f"--{leg}", "--child", "--chunk", str(args.chunk), "--height",
            str(args.height), "--width", str(args.width), "--device",
            args.device]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=LEG_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"the {leg} leg exited {r.returncode}:\n"
                           f"{r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["process_s"] = wall
    return out


def parser():
    p = argparse.ArgumentParser(
        description="Time to the first result of the port in a fresh "
                    "process (build directory as it stands, or empty).")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--fresh", dest="leg", action="store_const",
                   const="fresh")
    g.add_argument("--cold", dest="leg", action="store_const", const="cold")
    p.add_argument("--child", action="store_true",
                   help="run the leg in this process (what the parent "
                        "starts)")
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch versions")
    return p


def main(argv=None):
    t_start = time.perf_counter()
    args = parser().parse_args(argv)
    if args.child:
        print(json.dumps(child(args, t_start)), flush=True)
        return None
    from deepdish_tpu_torch.device import resolve_device
    from deepdish_tpu_torch.tools import bench
    info = bench.device_info(resolve_device(args.device))
    legs = [args.leg] if args.leg else ["fresh", "cold"]
    results = {}
    for leg in legs:
        r = run_leg(leg, args)
        results[leg] = r
        print(f"{leg}: " + ", ".join(f"{t} {r['seconds'][t]:.3f} s"
                                     for t in TERMS)
              + f"; process {r['process_s']:.3f} s"
              + (f" ({r['kernel_build_note']})" if r["kernel_build_note"]
                 else f" (kernels {', '.join(r['kernels'])})"), flush=True)
    ids = [results[leg]["track_ids"] for leg in legs]
    line = {"metric": f"time to the first result in a fresh process "
                      f"(run_chunk of {args.chunk} frames at "
                      f"{args.height}x{args.width})",
            "legs": results, "chunk": args.chunk,
            "frame": [args.height, args.width],
            "track_ids_equal": all(i == ids[0] for i in ids), **info}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
