"""CLI / config system of the port's CLI.

A copy of deepdish_tpu/pipeline/config.py (host code; the port keeps its
own): the reference's argument stack (deepdish.py:1347-1506) with the same
~70 flags and defaults, the shell-style `quoted_split` tokenizer, recursive
`--options-file` expansion with `#` comments and a cycle guard, and the
`DEEPDISHHOME` environment default; then the JAX package's additions (chunk
size, device, capacities), with the same names and defaults. `--device`
names a torch device: the default None means CUDA, and `--disable-edgetpu`
means the CPU.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from typing import List, Optional


def quoted_split(s: str) -> List[str]:
    """Shell-like tokenizer (deepdish.py:1347-1353)."""
    def strip_quotes(t):
        if t and (t[0] == '"' or t[0] == "'") and t[0] == t[-1]:
            return t[1:-1]
        return t
    return [strip_quotes(p).replace('\\"', '"').replace("\\'", "'")
            for p in re.findall(
                r'(?:[^"\s]*"(?:\\.|[^"])*"[^"\s]*)+'
                r'|(?:[^\'\s]*\'(?:\\.|[^\'])*\'[^\'\s]*)+'
                r'|[^\s]+', s)]


def expand_options_files(argv: List[str], basedir: str,
                         _seen: Optional[set] = None) -> List[str]:
    """Recursive --options-file include with cycle guard
    (deepdish.py:1357-1377)."""
    if _seen is None:
        _seen = set()
    out: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--options-file" or a.startswith("--options-file="):
            if "=" in a:
                path = a.split("=", 1)[1]
                i += 1
            else:
                path = argv[i + 1]
                i += 2
            full = path if os.path.isabs(path) else os.path.join(basedir, path)
            real = os.path.realpath(full)
            if real in _seen:
                raise ValueError(
                    f"options-file cycle detected at {path}")
            _seen.add(real)
            with open(full) as f:
                tokens: List[str] = []
                for line in f:
                    line = line.split("#", 1)[0].strip()
                    if line:
                        tokens.extend(quoted_split(line))
            out.extend(expand_options_files(tokens, basedir, _seen))
        else:
            out.append(a)
            i += 1
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepdish-tpu-torch")
    add = p.add_argument
    # --- reference flags (deepdish.py:1379-1496), same names/defaults ---
    add('--camera', metavar='N', default=0, type=int,
        help='camera number for live input (OpenCV numbering)')
    add('--gstreamer', metavar='PIPELINE', default=None,
        help='gstreamer pipeline for camera input')
    add('--gstreamer-nvidia', action='store_true', default=False)
    add('--input', default=None, help='input MP4 file for video file input')
    add('--input-cvat-dir', default=None,
        help='input CVAT-format data directory (instead of camera)')
    add('--output', default=None, help='output file with annotated frames')
    add('--output-cvat-dir', default=None,
        help='output annotations to CVAT-format data directory')
    add('--line', '-L', default=None, help='counting line: x1,y1,x2,y2')
    add('--model', metavar='FILE', default='ssd_mobilenet',
        help='object detection model name or file')
    add('--allow-random-weights', default=False, action='store_true',
        help='if converting a --model weight file fails, run with '
             'random-init weights instead of aborting')
    add('--quantized-inference', default=False, action='store_true',
        help='run a full-integer .tflite --model on the integer datapath '
             '(the TFLite interpreter\'s integer arithmetic, byte-exact head '
             'tensors) instead of dequantizing its weights to float; '
             'SSD/EdgeTPU, EfficientDet and YOLOv5 artifacts')
    add('--detector-int8', default=False, action='store_true',
        help='run the SSD-MobileNet detector convolutions as exact int8 '
             'contractions (fast w8a8 post-training mode, '
             'models/ssd_q.py), the detector analog of --encoder-model '
             'mars_int8; activation scales are calibrated on a synthetic '
             'image set unless --detector-calibration-frames is given')
    add('--detector-calibration-frames', default=None,
        help='optional .npy of (N, H, W, 3) float frames for '
             '--detector-int8 activation calibration')
    add('--disable-edgetpu', default=False, action='store_true',
        help='run on the CPU (the same as --device cpu)')
    add('--encoder-model', metavar='FILE', default=None)
    add('--encoder-batch-size', default=32, type=int, metavar='N',
        help='accepted for reference compatibility; a no-op here — the '
             'frame step encodes every detection of a frame in one batch '
             '(see --encode-capacity for the real knob)')
    add('--labels', metavar='FILE', default=None)
    # generic-TFLite detector option surface (ObjectDetectorOptions,
    # tools/tflite_object_detector.py:47-53): deny filter first, then
    # allow filter, then top-scored truncation — all in-jit on the native
    # EfficientDet/TFLite path (float and quantized)
    add('--label-allow-list', default=None, metavar='L1,L2',
        help='keep only detections whose label is in this comma-separated '
             'list (generic TFLite detector option)')
    add('--label-deny-list', default=None, metavar='L1,L2',
        help='drop detections whose label is in this comma-separated list '
             '(generic TFLite detector option)')
    add('--detector-max-results', default=-1, type=int, metavar='N',
        help='keep at most N top-scored detections after allow/deny '
             'filtering (-1 = unlimited; generic TFLite detector option)')
    add('--framebuffer', default=False, action='store_true')
    add('--framebuffer-device', '-F', default='/dev/fb0', metavar='DEVICE')
    add('--framebuffer-width', default=None, metavar='WIDTH', type=int)
    add('--framebuffer-height', default=None, metavar='HEIGHT', type=int)
    add('--color-mode', default=None, metavar='MODE',
        help='accepted for reference compatibility; dead in the reference '
             'too (deepdish.py:750 "fixme") — has no effect')
    add('--max-cosine-distance', metavar='N', default=0.2, type=float)
    add('--nms-max-overlap', metavar='N', default=0.6, type=float)
    add('--max-iou-distance', metavar='N', default=0.7, type=float)
    add('--max-age', metavar='N', default=60, type=int)
    add('--wanted-labels', metavar='LABEL1,LABEL2,...', default='person')
    add('--num-threads', '-N', metavar='N', default=4, type=int)
    add('--deepsorthome', metavar='PATH', default=None)
    add('--camera-flip', default=False, action='store_true')
    add('--camera-width', default=640, type=int)
    add('--camera-height', default=480, type=int)
    add('--disable-graphics', default=False, action='store_true')
    add('--streaming', default=True, type=lambda s: s not in
        ('0', 'false', 'False', ''))
    add('--streaming-port', default=8080, type=int)
    add('--stream-path', default=None)
    add('--control-port', default=9090, type=int, metavar='PORT')
    add('--mqtt-broker', default=None, metavar='HOST')
    add('--mqtt-port', default=1883, type=int, metavar='PORT')
    add('--mqtt-acp-id', default=None, metavar='ID')
    add('--mqtt-user', default=None, metavar='USER')
    add('--mqtt-pass', default=None, metavar='PASS')
    add('--mqtt-topic', default=None, metavar='TOPIC')
    add('--mqtt-verbosity', default=1, type=int, metavar='LEVEL')
    add('--heartbeat-delay-secs', default=300, metavar='SECS', type=int)
    add('--disable-background-subtraction', default=False,
        action='store_true')
    add('--background-subtraction-ratio', default=0.25, metavar='RATIO',
        type=float)
    add('--enable-background-masking', default=False, action='store_true')
    add('--interframe-interval', default=None, metavar='MSECS', type=int)
    add('--simulate-camera', default=[], metavar='DIM', nargs='+')
    add('--object-detector-skip-frames', default=None, metavar='N', type=int)
    add('--max-queue-size', default=5, metavar='N', type=int)
    add('--log', default=None, metavar='FILE')
    add('--restore-from-log', default=False, action='store_true')
    add('--object-annotation', default='LABEL', metavar='CATEGORY',
        choices=['ID', 'id', 'LABEL', 'label', 'NONE', 'none'])
    add('--cpu-temp-file', default=None, metavar='FILE')
    add('--cpu-freq-file', default=None, metavar='FILE')
    add('--disable-powersaving', default=False, action='store_true')
    add('--powersave-delay-increment', default=10, metavar='MSEC', type=int)
    add('--powersave-delay-maximum', default=500, metavar='MSEC', type=int)
    add('--focallength-mm', default=None, metavar='MM', type=float)
    add('--sensor-width-mm', default=None, metavar='MM', type=float)
    add('--sensor-height-mm', default=None, metavar='MM', type=float)
    add('--elevation-m', default=None, metavar='M', type=float)
    add('--tilt-deg', default=None, metavar='DEG', type=float)
    add('--roll-deg', default=0.0, metavar='DEG', type=float)
    add('--topdownview-size-m', default=None, metavar='X,Y')
    add('--3d', default=False, action='store_true', dest='three_d')
    add('--raw-output', default=False, action='store_true')
    add('--score-threshold', default=0.5, type=float, metavar='N')
    # --- the JAX package's additions ---
    add('--chunk-size', default=1, type=int, metavar='F',
        help='frames per frame-step call (throughput mode)')
    add('--decode-stripes', default=1, type=int, metavar='K',
        help='decode the (single) input file with K parallel keyframe-'
             'striped decoder threads (offline mode, needs --chunk-size>1; '
             'byte-equal to sequential decode). Sequential mp4 decode tops '
             'out at ~1 core; use K~cores when decode binds throughput. '
             'Falls back to sequential if the container reports no frame '
             'count')
    add('--max-tracks', default=64, type=int, metavar='N')
    add('--max-detections', default=32, type=int, metavar='N')
    add('--gallery-size', default=128, type=int, metavar='N')
    add('--gallery-max', default=4096, type=int, metavar='N',
        help='auto-grow the appearance gallery (exact unbounded-gallery '
             'parity with the reference, deepdish.py:515) up to N features '
             'per track before ring reuse begins')
    add('--disable-gallery-growth', default=False, action='store_true',
        help='keep the fixed-size gallery ring (oldest features overwritten '
             'past --gallery-size)')
    add('--encode-capacity', default=0, type=int, metavar='E',
        help='appearance-encode at most E detections per frame (0 = all; '
             'detections past E are tracked by IoU only that frame)')
    add('--device', default=None, metavar='DEVICE',
        help='torch device (default: cuda, which raises without a card; '
             'cpu runs the plain PyTorch versions)')
    add('--max-frames', default=None, type=int, metavar='N',
        help='stop after N frames (benchmarks/tests)')
    add('--profile-dir', default=None, metavar='DIR',
        help='write a torch.profiler trace (trace.json) of the first '
             'frames (device-time view of the latency taxonomy)')
    add('--profile-frames', default=32, type=int, metavar='N')
    add('--state-checkpoint', default=None, metavar='FILE',
        help='checkpoint/restore the FULL tracker+bgsub state (beyond the '
             'counters-only log restore of the reference)')
    # consumed by expand_options_files BEFORE parsing (deepdish.py:1362-1377
    # semantics); declared here only so --help documents it.
    add('--options-file', default=None, metavar='FILE',
        help='read additional options from FILE (shell-style quoting, '
             '# comments, recursive includes with a cycle guard; expanded '
             'before parsing, relative to DEEPDISHHOME)')
    return p


def get_arguments(argv=None) -> argparse.Namespace:
    basedir = os.getenv('DEEPDISHHOME', '.')
    if argv is None:
        argv = sys.argv[1:]
    argv = expand_options_files(list(argv), basedir)
    p = build_parser()
    args = p.parse_args(argv)
    if args.deepsorthome is None:
        args.deepsorthome = basedir
    args.basedir = basedir
    return args
