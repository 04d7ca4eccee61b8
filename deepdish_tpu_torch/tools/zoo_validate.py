"""One-command validation battery for a user-supplied zoo artifact, through
the port on one card.

Port of the repository's tools/zoo_validate.py: the same battery, step
names, PASS / FAIL / SKIP / WARN rules, last JSON line and exit codes (0,
1 on any FAIL, 2 for a missing file), through the port's modules:

    python -m deepdish_tpu_torch.tools.zoo_validate path/to/detect.tflite \
        [--labels FILE] [--skip-drive] [--device cuda]

  1. parse    flatbuffer structure, IO quantization scheme, fused
              postprocess-op parameters (models/convert.py, tflite_meta.py)
  2. anchors  pp-op artifacts: the embedded anchor table against the
              port's generated grids (SSD-MobileNetV1, EfficientDet at 320,
              384, 448)
  3. convert  the registry's float conversion (models/registry.py
              `create_detector`; strict: every weight tensor consumed)
  4. integer  full-integer artifacts: models/qgraph.py's executor against
              tf.lite.Interpreter's reference kernels, every op-output
              tensor byte-equal (or the final outputs within 1 LSB of the
              default resolver when the reference one cannot run the graph)
  5. detect   the port's detector against models/tflite_host.py's
              interpreter detections on a synthetic scene (IoU > 0.5,
              score within 0.1)
  6. drive    a 16-frame synthetic mp4 through the port's CLI
              (`python -m deepdish_tpu_torch.pipeline.main`, --device passed
              through, --streaming 0 --control-port 0) with the artifact
              and no --allow-random-weights: conversion must have really
              succeeded

Encoder artifacts (a file name containing 'mars' or 'encoder') run the
encoder battery instead: the encoder factory's load (the integer datapath
for a full-integer file, else the structural float conversion) and the
embeddings' cosine drift against the interpreter. Without tensorflow (the
card's machine has none) integer, detect and embed SKIP. tensorflow and
cv2 are imported inside the steps that need them. The last JSON line also
carries the bench's `platform` and `device` keys (the card's name and
power limit).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from . import bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = []


def record(step, status, detail=""):
    RESULTS.append((step, status, detail))
    print(f"[{status:4s}] {step}: {detail}", flush=True)


def _tf():
    try:
        import tensorflow as tf
        return tf
    except Exception:
        return None


def _scene(h, w):
    img = np.full((h, w, 3), 40, np.uint8)
    img[h // 4: 3 * h // 4, w // 8: w // 8 + w // 5] = 230
    img[h // 3: h // 2, w // 2: w // 2 + w // 6] = 180
    return img


def step_parse(path):
    from ..models.convert import read_tflite_io_quant, read_tflite_postprocess
    io = read_tflite_io_quant(path)
    pp = read_tflite_postprocess(path)
    in_dt = next(iter(io.values()))[0] if io else None
    scheme = ("full-int8" if in_dt is np.int8 else
              "legacy-uint8" if in_dt is np.uint8 else "float")
    detail = f"input dtype {np.dtype(in_dt).name if in_dt else '?'} -> {scheme}"
    if pp is not None:
        detail += (f"; fused postprocess op: {pp.num_classes} classes, "
                   f"{len(pp.anchors)} anchors")
    record("parse", "PASS", detail)
    return scheme, pp


def step_anchors(path, pp):
    if pp is None:
        record("anchors", "SKIP", "no fused postprocess op")
        return
    from ..models.efficientdet import generate_anchors as eff_anchors
    from ..models.ssd_mobilenet import generate_anchors as ssd_anchors
    a = np.asarray(pp.anchors, np.float32)
    best = None
    cands = {"ssd_mobilenet_v1": np.asarray(ssd_anchors(), np.float32)}
    for size in (320, 384, 448):
        cands[f"efficientdet@{size}"] = (
            eff_anchors(size).astype(np.float32) / size)
    for name, grid in cands.items():
        if grid.shape != a.shape:
            continue
        dev = float(np.max(np.abs(grid - a)))
        if best is None or dev < best[1]:
            best = (name, dev)
    if best is None:
        record("anchors", "WARN",
               f"{len(a)} anchors match no generated family grid's shape "
               "(custom anchor config — decode still uses the embedded "
               "table, so this is informational)")
    elif best[1] < 1e-3:
        record("anchors", "PASS", f"embedded table == {best[0]} grid "
               f"(max dev {best[1]:.2e})")
    else:
        record("anchors", "WARN", f"closest family grid {best[0]} deviates "
               f"{best[1]:.4f} (embedded table is used for decode)")


def step_convert(path, labels, device):
    from ..models.registry import create_detector
    det = create_detector(path, label_file=labels, score_threshold=0.3,
                          device=device)
    record("convert", "PASS",
           f"float conversion ok ({type(det).__name__}, input "
           f"{det.width}x{det.height})")
    return det


def _interpreter_input(meta_in):
    x = np.random.RandomState(0).randint(
        0, 256, tuple(meta_in.shape)).astype(np.uint8)
    if meta_in.dtype == np.int8:
        x = (x.astype(np.int32) - 128).astype(np.int8)
    return x


def step_integer(path, scheme, device):
    if scheme == "float":
        record("integer", "SKIP", "not a full-integer artifact")
        return None
    tf = _tf()
    if tf is None:
        record("integer", "SKIP", "tensorflow unavailable for the "
               "interpreter reference")
        return None
    import torch

    from ..models.qgraph import QGraphExecutor
    ex = QGraphExecutor(path, conv_impl="portable", device=device)
    x = _interpreter_input(ex.meta[ex.input_idx])
    xt = torch.from_numpy(x).to(ex.device)
    try:
        rt = tf.lite.experimental.OpResolverType.BUILTIN_REF
        ip = tf.lite.Interpreter(model_path=path,
                                 experimental_op_resolver_type=rt,
                                 experimental_preserve_all_tensors=True)
        ip.allocate_tensors()
        ip.set_tensor(ip.get_input_details()[0]["index"], x)
        ip.invoke()
        env = ex.apply(xt, return_env=True)
        n = 0
        for qop in ex.ops:
            ti = qop.outputs[0]
            ref = ip.get_tensor(ti)
            ours = env[ti].cpu().numpy()
            if not np.array_equal(ours, ref):
                record("integer", "FAIL",
                       f"tensor {ex.meta[ti].name} differs from the "
                       "reference kernels")
                return ex
            n += 1
        record("integer", "PASS",
               f"all {n} op-output tensors byte-equal vs BUILTIN_REF")
    except Exception as e:
        # the reference resolver cannot run some artifacts (e.g. int8 TILE
        # v3): final outputs against the default (XNNPACK) resolver
        try:
            ip = tf.lite.Interpreter(model_path=path)
            ip.allocate_tensors()
            ip.set_tensor(ip.get_input_details()[0]["index"], x)
            ip.invoke()
            outs = [o.cpu().numpy() for o in ex.apply(xt)]
            for d, ours in zip(ip.get_output_details(), outs):
                ref = ip.get_tensor(d["index"])
                if ours.dtype == np.float32:
                    ok = np.allclose(ours, ref, atol=1e-2, rtol=1e-2)
                else:
                    ok = np.max(np.abs(ours.astype(np.int64)
                                       - ref.astype(np.int64))) <= 1
                if not ok:
                    record("integer", "FAIL",
                           f"final tensor {d['name']} beyond 1 LSB of the "
                           "XNNPACK resolver")
                    return ex
            record("integer", "PASS",
                   f"final outputs within 1 LSB of XNNPACK (reference "
                   f"resolver could not run the graph: {e})")
        except Exception as e2:
            record("integer", "FAIL", f"interpreter comparison failed: {e2}")
    return ex


def step_detect(path, det):
    tf = _tf()
    if tf is None:
        record("detect", "SKIP", "tensorflow unavailable")
        return
    import cv2
    import torch

    from ..models.tflite_host import TFLiteHostDetector
    h, w = 480, 640
    frame = _scene(h, w)
    try:
        host = TFLiteHostDetector(path, wanted_labels=None,
                                  score_threshold=0.3, max_results=32)
        host.wanted_labels = list(host.labels.values()) or ["person"]
        ref_tlwh, ref_names, ref_scores = host.detect_host(frame)
    except Exception as e:
        record("detect", "SKIP", f"interpreter drive failed ({e}) — raw-"
               "heads artifact without the fused op, or metadata-free")
        return
    resized = cv2.resize(frame, (det.width, det.height)).astype(np.float32)
    with torch.inference_mode():
        got = det.detect(torch.from_numpy(resized)[None].to(det.device),
                         float(w), float(h))
    xyxy, classes, scores, valid = (t[0].cpu().numpy() for t in got)
    ours = [((x1, y1, x2 - x1, y2 - y1), float(s))
            for (x1, y1, x2, y2), s, v in zip(xyxy, scores, valid) if v]
    if not ref_tlwh and not ours:
        record("detect", "PASS", "both sides detect nothing on the "
               "synthetic scene (scene-dependent; not a failure)")
        return
    matched = 0
    for (bt, bs) in zip(ref_tlwh, ref_scores):
        bx = np.asarray(bt, np.float32)
        for (ot, os_) in ours:
            ob = np.asarray(ot, np.float32)
            x1 = max(bx[0], ob[0])
            y1 = max(bx[1], ob[1])
            x2 = min(bx[0] + bx[2], ob[0] + ob[2])
            y2 = min(bx[1] + bx[3], ob[1] + ob[3])
            inter = max(0, x2 - x1) * max(0, y2 - y1)
            union = bx[2] * bx[3] + ob[2] * ob[3] - inter
            if union > 0 and inter / union > 0.5 and abs(bs - os_) < 0.1:
                matched += 1
                break
    frac = matched / max(1, len(ref_tlwh))
    status = "PASS" if frac >= 0.8 else "FAIL"
    record("detect", status,
           f"{matched}/{len(ref_tlwh)} interpreter detections matched by "
           f"the port's path (IoU>0.5, score +-0.1); ours={len(ours)}")


def write_drive_video(path):
    """The drive step's 16 frames (320x240, a block moving right) as an
    mp4 through cv2's writer."""
    import cv2
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                         (320, 240))
    for i in range(16):
        f = np.full((240, 320, 3), 40, np.uint8)
        f[60:180, 10 + 12 * i: 70 + 12 * i] = 230
        vw.write(f)
    vw.release()


def step_drive(path, labels, quantized, device):
    with tempfile.TemporaryDirectory() as td:
        video = os.path.join(td, "drive.mp4")
        write_drive_video(video)
        log = os.path.join(td, "out.log")
        argv = [sys.executable, "-m", "deepdish_tpu_torch.pipeline.main",
                "--input", video, "--model", path, "--encoder-model",
                "constant.pb", "--disable-graphics", "--streaming", "0",
                "--control-port", "0", "--log", log, "--wanted-labels",
                "person", "--device", device]
        if labels:
            argv += ["--labels", labels]
        if quantized:
            argv += ["--quantized-inference"]
        r = subprocess.run(argv, capture_output=True, text=True,
                           timeout=1200, cwd=ROOT)
        if r.returncode != 0:
            record("drive", "FAIL",
                   f"CLI exited {r.returncode}: {r.stderr[-300:]}")
        else:
            n = sum(1 for _ in open(log)) if os.path.exists(log) else 0
            record("drive", "PASS", f"CLI pipeline completed; log at "
                   f"{os.path.basename(log)} ({n} lines)")


def encoder_battery(path, device):
    import torch

    from ..models.encoders import create_box_encoder
    # full-integer artifacts run on the integer datapath (models/qgraph.py),
    # float ones convert structurally
    enc = create_box_encoder(path, device=device)
    kind = ("integer datapath" if hasattr(enc, "executor")
            else "structural float conversion")
    record("convert", "PASS", f"MARS encoder loaded ({kind}, "
           f"{enc.image_shape[0]}x{enc.image_shape[1]} crops)")
    patches = np.random.RandomState(0).randint(
        0, 256, (8,) + tuple(enc.image_shape)).astype(np.float32)
    with torch.inference_mode():
        ours = enc.apply(torch.from_numpy(patches).to(enc.device))
    ours = ours.float().cpu().numpy()
    tf = _tf()
    if tf is None or not path.endswith(".tflite"):
        record("embed", "SKIP", "interpreter comparison needs a .tflite "
               "artifact and tensorflow")
        return
    ip = tf.lite.Interpreter(model_path=path)
    ip.allocate_tensors()
    din = ip.get_input_details()[0]
    feats = []
    for p in patches:
        x = p[None].astype(din["dtype"]) if din["dtype"] != np.float32 \
            else p[None]
        ip.set_tensor(din["index"], x)
        ip.invoke()
        feats.append(ip.get_tensor(ip.get_output_details()[0]["index"])[0])
    ref = np.asarray(feats, np.float32)
    ref = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-8)
    cos = 1.0 - (ref * ours).sum(axis=1)
    status = "PASS" if np.max(np.abs(cos)) < 0.05 else "FAIL"
    record("embed", status,
           f"max cosine drift vs interpreter {np.max(np.abs(cos)):.4f} "
           "(threshold 0.05; matching threshold is 0.2)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact")
    ap.add_argument("--labels", default=None)
    ap.add_argument("--skip-drive", action="store_true",
                    help="skip the CLI pipeline drive (slow on CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch versions")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    RESULTS.clear()
    path = args.artifact
    if not os.path.isfile(path):
        print(f"artifact not found: {path}", file=sys.stderr)
        return 2
    name = os.path.basename(path).lower()

    if "mars" in name or "encoder" in name:
        encoder_battery(path, dev)
    else:
        scheme, pp = step_parse(path)
        step_anchors(path, pp)
        det = None
        try:
            det = step_convert(path, args.labels, dev)
        except Exception as e:
            record("convert", "FAIL", str(e)[:300])
        step_integer(path, scheme, dev)
        if det is not None:
            try:
                step_detect(path, det)
            except Exception as e:
                record("detect", "FAIL", str(e)[:300])
        if not args.skip_drive:
            step_drive(path, args.labels, False, str(dev))

    failed = [s for s, st, _ in RESULTS if st == "FAIL"]
    print(json.dumps({"artifact": os.path.basename(path),
                      "steps": {s: st for s, st, _ in RESULTS},
                      "ok": not failed, **bench.device_info(dev)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
