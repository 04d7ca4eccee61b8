"""The asyncio pipeline runtime of the port's CLI.

Port of deepdish_tpu/pipeline/runtime.py `Pipeline`, itself the reference
Pipeline (deepdish.py:446-1345) re-designed around one frame step: the
reference runs capture -> detect -> encode -> track -> results -> render
with each ML step dispatched to threads; here detection, embedding and
tracking are one `FrameStep` call on the device, so the stage graph is

    capthread -> capture -> infer(device) -> results(analytics) -> render

connected by the same bounded queues and FreshQueue freshness rule, with the
same per-frame timing taxonomy (fcap/fram/q1/bsub/objd/q2/ienc/feat/q3/
trak/q4/proc/q5/disp + sum/e2e/miss/f2f, deepdish.py:975-1281). The stage
latencies the frame step absorbs (bsub/ienc/feat/trak) are reported as 0 and
their cost shows in `objd`, the frame step's wall time.

With --chunk-size F > 1 the infer stage hands F frames to one
`FrameStep.run_chunk` (offline throughput mode); live input keeps F = 1.

Differences from the JAX runtime:
  * the weights stay on the device; a frame goes up once per step;
  * `_device_step` moves each batch's TrackStepOutput and
    DetectionSnapshot to host numpy in one copy; the analytics stages run on
    numpy, as in the JAX package;
  * --profile-dir writes a torch.profiler trace;
  * CVAT mode reads each frame's detections and track outputs on the
    host between the two halves of the step (two device-to-host copies a
    frame, three on a frame with a track override), the reference's own
    ordering;
  * the capture source is opened in one method, `_open_capture`
    (cv2.VideoCapture), which tests and chip_smoke.py replace with a numpy
    frame source; cv2 and PIL are imported only where a file or camera is
    opened, a frame is resized, flipped, drawn or converted on the host.
"""
from __future__ import annotations

import asyncio
import json
import os
import threading
from collections import deque
from time import asctime, localtime, sleep, time
from typing import Optional

import numpy as np
import torch

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

from .. import device as devmod
from .. import tracker as tt
from ..device import resolve_device
from ..models import create_box_encoder, create_detector
from ..ops import boxes as boxops
from ..tracker.overrides import delete_slots, force_update_slots
from .camera3d import GroundCamera
from .checkpoint import load_state, save_state
from .counting import CountingState
from .elements import (CameraCountLine, CameraImage, CountingStats,
                       DetectedObject, FontLib, FrameInfo, PipelineInfo,
                       RenderInfo, TempInfo, TimingInfo, TopDownObj,
                       TopDownView, TrackedObject, TrackedPath,
                       TrackedPathIntersection)
from .framerecords import FrameRecords
from .framestep import FrameStep, FrameStepConfig, PipelineState
from .mjpeg import MJPEGServer, StreamingInfo
from .mqtt import MQTTClient

# cv2.CAP_PROP_* (plain ints, so the runtime needs no cv2 to name them)
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5
CAP_PROP_BUFFERSIZE = 38

class MBox:
    """1-slot mutex mailbox (deepdish.py:79-93)."""

    def __init__(self):
        self.message = None
        self.lock = threading.Lock()

    def get_message(self):
        with self.lock:
            return self.message

    def set_message(self, message):
        with self.lock:
            self.message = message


def capthread_f(cap, kickstart, box, everyframe, interframe_interval, simcam,
                stop):
    """Blocking capture loop in its own thread (deepdish.py:95-129),
    including the adaptive inter-frame delay, until EOF or `stop`. This
    thread alone releases `cap`: a VideoCapture released from another
    thread while this one is inside `cap.read()` can deadlock both."""
    count = 0
    delay = interframe_interval
    try:
        kickstart.wait()
        prev_t = time()
        ret = True
        while ret and not stop.is_set():
            t1 = time()
            ret, frame = cap.read()
            if not ret:
                frame = None
            elif simcam:
                import cv2
                frame = cv2.resize(frame, tuple(simcam))
            t2 = time()
            dt = t2 - prev_t
            prev_t = t2
            count += 1
            box.set_message((count, frame, t2, t2 - t1))
            if everyframe is not None:
                everyframe.wait()
                everyframe.clear()
            elif interframe_interval is not None and frame is not None:
                if dt < interframe_interval:
                    delay += 0.001
                elif dt > interframe_interval:
                    delay -= 0.001
                delay = max(0, delay)
                sleep(delay)
    finally:
        cap.release()


class FreshQueue(asyncio.Queue):
    """Queue keeping only the newest item (deepdish.py:192-203)."""

    def _init(self, maxsize):
        self._queue = []

    def _put(self, item):
        self._queue = [item]

    def _get(self):
        item = self._queue[0]
        self._queue = []
        return item

    def full(self):
        return False


def gstreamer_nvidia_pipeline(width: int, height: int) -> str:
    """The nvargus camera source string the reference builds for
    --gstreamer-nvidia (deepdish.py:698-703)."""
    return ("nvarguscamerasrc ! video/x-raw(memory:NVMM), "
            f"width=(int){width}, height=(int){height}, "
            "format=(string)NV12, framerate=(fraction)30/1 ! "
            "nvvidconv flip-method=0 ! "
            "video/x-raw, format=(string)BGRx ! videoconvert ! "
            "video/x-raw, format=(string)BGR ! appsink drop=true")


def to_host(*tuples):
    """NamedTuples of device tensors -> the same NamedTuples of numpy
    arrays, through ONE device-to-host copy (every field's bytes are packed
    into one buffer on the device first)."""
    fields = [t for nt in tuples for t in nt]
    flat = devmod.sync_numpy(torch.cat(
        [t.contiguous().reshape(-1).view(torch.uint8) for t in fields]),
        "outputs")
    arrays, at = [], 0
    for t in fields:
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        n = t.numel() * dtype.itemsize
        arrays.append(flat[at:at + n].view(dtype).reshape(t.shape))
        at += n
    out, k = [], 0
    for nt in tuples:
        out.append(type(nt)(*arrays[k:k + len(nt)]))
        k += len(nt)
    return out


def _per_frame(outs, snaps):
    """Stacked (F, ...) outputs -> [(TrackStepOutput, DetectionSnapshot)]
    of numpy, one pair a frame."""
    outs, snaps = to_host(outs, snaps)
    return [(type(outs)(*(x[i] for x in outs)),
             type(snaps)(*(x[i] for x in snaps)))
            for i in range(len(outs.track_id))]


class Pipeline:
    """Host orchestrator around the frame step."""

    def __init__(self, args):
        self.args = args
        # --device names a torch device; None means CUDA (raises without a
        # card) and --disable-edgetpu the CPU (deepdish.py:1397-1398)
        self.device = resolve_device(
            args.device or ('cpu' if args.disable_edgetpu else None))
        self.process = psutil.Process() if psutil else None
        self.running = False

        self.wanted_labels = args.wanted_labels.strip().split(',')

        self._init_camera()
        self._init_output()
        self._init_native_loader()

        def _csv(v):
            return [s.strip() for s in v.split(',') if s.strip()] \
                if v else None
        self.detector = create_detector(
            args.model, wanted_labels=self.wanted_labels,
            label_file=args.labels, score_threshold=args.score_threshold,
            max_outputs=max(args.max_detections, 32),
            allow_random_weights=getattr(args, 'allow_random_weights',
                                         False),
            quantized=getattr(args, 'quantized_inference', False),
            detector_int8=getattr(args, 'detector_int8', False),
            calib_images=self._load_calibration_frames(
                getattr(args, 'detector_calibration_frames', None)),
            label_allow=_csv(getattr(args, 'label_allow_list', None)),
            label_deny=_csv(getattr(args, 'label_deny_list', None)),
            max_results=getattr(args, 'detector_max_results', -1),
            device=self.device)
        enc_name = args.encoder_model or 'mars-64x32x3.pb'
        self.encoder = create_box_encoder(enc_name, device=self.device)
        # Live mode (camera: frames may drop) pre-sizes the gallery from
        # --max-age and lets ring reuse take over past that (bounded
        # divergence from the reference's unbounded gallery,
        # deepdish.py:515); offline mode (file input) grows it exactly.
        # Ported as written: the choice changes the outputs.
        self._gallery_growth_ok = (self.everyframe is not None
                                   or self.native_loader is not None)
        gallery_size = args.gallery_size
        if not self._gallery_growth_ok and not args.disable_gallery_growth:
            gallery_size = min(args.gallery_max,
                               max(gallery_size, 4 * args.max_age))
            if gallery_size != args.gallery_size:
                print(f'Live input: appearance gallery pre-sized to '
                      f'{gallery_size} features/track (no mid-stream '
                      'growth in live mode).')
        self.tracker_cfg = tt.TrackerConfig(
            max_tracks=args.max_tracks,
            max_detections=args.max_detections,
            feature_dim=self.encoder.feature_dim,
            gallery_size=gallery_size,
            num_labels=max(len(self.wanted_labels), 1),
            max_cosine_distance=args.max_cosine_distance,
            max_iou_distance=args.max_iou_distance,
            max_age=args.max_age)
        w, h = self.input_size
        self.framestep = self._make_framestep(
            (h, w), FrameStepConfig(
                nms_max_overlap=args.nms_max_overlap,
                score_threshold=args.score_threshold,
                background_subtraction=not
                    args.disable_background_subtraction,
                background_ratio=args.background_subtraction_ratio,
                background_masking=args.enable_background_masking,
                encode_capacity=args.encode_capacity))
        self.state = self.framestep.init_state()
        self._prev_raw = None
        self._skip_rem = 0

        # CVAT annotation merge (deepdish.py:613-641, framerecords.py)
        self.framerec = None
        if args.input_cvat_dir is not None or \
                args.output_cvat_dir is not None:
            self.framerec = FrameRecords(self.detector.labels)
            if args.input_cvat_dir is not None:
                xml = os.path.join(args.input_cvat_dir, 'annotations.xml')
                if os.path.exists(xml):
                    self.framerec = FrameRecords.from_cvat_xml(
                        xml, self.detector.labels)

        # analytics
        self.counting = CountingState(self.wanted_labels,
                                      self.cameracountline)
        self.data_lock = asyncio.Lock()
        self.framenum_committed = 0
        self.frame_count = 0
        self.final_frame = None
        self.capture_eof = False

        # log / restore (deepdish.py:545-561)
        self.log = args.log
        if self.log is not None:
            if args.restore_from_log and os.path.exists(self.log):
                with open(self.log) as f:
                    q = deque(f, 1)
                    if q:
                        data = json.loads(q.pop())
                        self.counting.restore(data)
                        self.frame_count = data.get('frame_count', 0)
            else:
                with open(self.log, mode='w+') as f:
                    f.truncate()

        # full-state checkpoint restore, after the log restore so that it
        # takes precedence over --restore-from-log
        if args.state_checkpoint and os.path.exists(args.state_checkpoint):
            try:
                # a checkpoint saved after gallery growth has a larger
                # gallery axis than the configured tracker: grow ours first
                with np.load(args.state_checkpoint) as _f:
                    g_ckpt = (_f['table/gallery'].shape[1]
                              if 'table/gallery' in _f.files else None)
                if g_ckpt is not None and \
                        g_ckpt > self.tracker_cfg.gallery_size:
                    self.tracker_cfg, table = tt.grow_gallery(
                        self.tracker_cfg, self.state.table, g_ckpt)
                    self.framestep = self._make_framestep()
                    self.state = PipelineState(table, self.state.bg)
                    print(f'Tracker gallery grown to {g_ckpt} to match '
                          'the checkpoint.')
                self.state, counters, fc = load_state(
                    args.state_checkpoint, self.state)
                self.counting.restore(counters)
                self.frame_count = fc
                print(f'Restored pipeline state from '
                      f'{args.state_checkpoint} (frame {fc}).')
            except (OSError, ValueError, KeyError) as e:
                print(f'State checkpoint ignored: {e}')

        # MQTT
        self.mqtt: Optional[MQTTClient] = None
        self.topic = args.mqtt_topic
        self.mqtt_acp_id = args.mqtt_acp_id
        self.heartbeat_delay_secs = args.heartbeat_delay_secs

        # web stream
        self.streaminfo = StreamingInfo()
        self.webserver: Optional[MJPEGServer] = None

        # 3-D mode (deepdish.py:589-611)
        self.cam = None
        self.topdownview = None
        self.topdownview_scalefactors = None
        if args.three_d:
            if None in (args.focallength_mm, args.sensor_width_mm,
                        args.sensor_height_mm, args.elevation_m,
                        args.tilt_deg):
                raise ValueError('3-D transform requires focallength, '
                                 'sensor size, camera elevation and tilt.')
            self.cam = GroundCamera(
                args.focallength_mm,
                (args.sensor_width_mm, args.sensor_height_mm),
                self.input_size, args.elevation_m, args.tilt_deg,
                args.roll_deg)
            defaultviewsize = ((0, 0), (w / 4, h / 4))
            self.topdownview = defaultviewsize
            if args.topdownview_size_m is not None:
                size = np.array(list(map(
                    int, args.topdownview_size_m.strip().split(','))),
                    dtype=float)
                self.topdownview_scalefactors = \
                    np.array(defaultviewsize[1], dtype=float) / size
            else:
                self.topdownview_scalefactors = np.array([1, 1])

        # powersave (deepdish.py:582-587)
        self.powersave_delay = 0.0
        self.powersave_delay_maximum = args.powersave_delay_maximum / 1000.0
        self.powersave_delay_increment = (
            0 if args.disable_powersaving
            else args.powersave_delay_increment / 1000.0)

        # temperature / frequency sources (deepdish.py:565-580)
        self.cpu_temp_file = args.cpu_temp_file or \
            '/sys/class/thermal/thermal_zone0/temp'
        if not os.path.exists(self.cpu_temp_file):
            self.cpu_temp_file = None
        self.cpu_freq_file = args.cpu_freq_file or \
            '/sys/devices/system/cpu/cpu0/cpufreq/scaling_cur_freq'
        if not os.path.exists(self.cpu_freq_file):
            self.cpu_freq_file = None
        # the governor file lives next to the freq file (deepdish.py:576-580)
        self.cpu_gov_file = None
        if self.cpu_freq_file is not None:
            gov = os.path.join(os.path.dirname(self.cpu_freq_file),
                               'scaling_governor')
            if os.path.exists(gov):
                self.cpu_gov_file = gov
        self.cpu_governor = self._read_cpu_governor()

        self.t_prev = None
        self.loop = None
        self._profiler = None

    def _make_framestep(self, frame_shape=None, step_cfg=None):
        """A FrameStep for the current tracker config (frame shape and step
        config default to the current frame step's)."""
        fs = getattr(self, 'framestep', None)
        return FrameStep(
            self.detector, self.encoder, self.tracker_cfg,
            self.wanted_labels,
            frame_shape or (fs.frame_h, fs.frame_w),
            step_cfg or fs.step_cfg, device=self.device)

    # ------------------------------------------------------------------
    def _open_capture(self, source):
        """The frame source: an object with read() -> (ok, BGR uint8
        frame), get(prop), set(prop, value) and release(), as
        cv2.VideoCapture has."""
        import cv2
        return cv2.VideoCapture(source)

    @staticmethod
    def _load_calibration_frames(path):
        """--detector-calibration-frames: (N, H, W, 3) float .npy of real
        frames for the --detector-int8 activation calibration (None: the
        synthetic set of models/ssd_q.py). A bad file fails loudly, as a
        weight file does."""
        if not path:
            return None
        frames = np.load(path)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f'--detector-calibration-frames {path!r}: expected '
                f'(N, H, W, 3), got {frames.shape}')
        return frames.astype(np.float32)

    def _init_camera(self):
        args = self.args
        self.simcam = None
        self.everyframe = None
        self.input = args.input
        if args.input_cvat_dir is not None:
            # the annotated frame sequence, handed over frame by frame
            self.input = os.path.join(args.input_cvat_dir,
                                      'images/frame_%06d.jpg')
            self.everyframe = threading.Event()
            args.disable_powersaving = True
        elif self.input is None:
            if args.gstreamer is not None:
                self.input = args.gstreamer
            elif args.gstreamer_nvidia:
                self.input = gstreamer_nvidia_pipeline(args.camera_width,
                                                       args.camera_height)
            else:
                self.input = args.camera
        else:
            if args.simulate_camera:
                simcam = [int(n) for n in args.simulate_camera]
                if len(simcam) == 1:
                    simcam = [simcam[0], simcam[0]]
                self.simcam = simcam[:2]
            if args.interframe_interval is None:
                self.everyframe = threading.Event()
            args.disable_powersaving = True

        # loud failure on a mistyped --input path (a missing file would
        # otherwise open with 0 frames and look like a clean 0-count run)
        if (isinstance(self.input, str) and args.gstreamer is None
                and not args.gstreamer_nvidia
                and '://' not in self.input and '%' not in self.input
                and not os.path.exists(self.input)):
            raise FileNotFoundError(f'--input file not found: {self.input}')

        self.cap = self._open_capture(self.input)
        self.cap.set(CAP_PROP_BUFFERSIZE, 1)
        self.input_size = (int(self.cap.get(CAP_PROP_FRAME_WIDTH)),
                           int(self.cap.get(CAP_PROP_FRAME_HEIGHT)))
        if self.simcam:
            self.input_size = tuple(self.simcam)
            real = (int(self.cap.get(CAP_PROP_FRAME_WIDTH)),
                    int(self.cap.get(CAP_PROP_FRAME_HEIGHT)))
            self.trackdata_ratios = (real[0] / self.simcam[0],
                                     real[1] / self.simcam[1])
        else:
            self.trackdata_ratios = (1, 1)
        if self.input_size[0] <= 0:
            self.input_size = (args.camera_width, args.camera_height)
        # countline default: vertical at w/2 (deepdish.py:739-743)
        if args.line is None:
            w, h = self.input_size
            self.countline = np.array([[w / 2, 0], [w / 2, h]], dtype=int)
        else:
            self.countline = np.array(
                list(map(int, args.line.strip().split(','))),
                dtype=int).reshape(2, 2)
        self.cameracountline = self.countline.astype(float)

    def _init_native_loader(self):
        """Offline throughput path: for plain video-file input with
        --chunk-size > 1, decode with the native C++ loader
        (native/frameloader.cpp) straight to I420 and convert to RGB on the
        device (FrameStep.run_chunk_yuv). Falls back to the capture thread
        when the loader cannot be built (no OpenCV) or the input needs host
        preprocessing (CVAT, flip, simulated camera)."""
        args = self.args
        self.native_loader = None
        self.native_yuv = False
        if (int(args.chunk_size) > 1 and isinstance(self.input, str)
                and os.path.isfile(self.input)
                and args.input_cvat_dir is None
                and not args.camera_flip and self.simcam is None):
            try:
                from ..utils.native import (NativeFrameLoader,
                                            StripedFrameLoader)
                w, h = self.input_size
                stripes = int(getattr(args, 'decode_stripes', 1) or 1)
                if stripes > 1:
                    # keyframe-striped parallel decode of the one input
                    # file, byte-equal to sequential decode
                    try:
                        self.native_loader = StripedFrameLoader(
                            self.input, n_workers=stripes,
                            out_w=w, out_h=h, yuv420=True)
                    except RuntimeError as e:
                        print(f'Striped decode unavailable ({e}); '
                              'using the sequential native loader.')
                if self.native_loader is None:
                    self.native_loader = NativeFrameLoader(
                        [self.input], w, h, yuv420=True)
                self.native_yuv = True
                if self.cap is not None:
                    self.cap.release()
                    self.cap = None
            except (RuntimeError, OSError) as e:
                print(f'Native frame loader unavailable ({e}); '
                      'using the capture thread.')

    def _init_output(self):
        args = self.args
        self.output = None
        self.backbuf = None
        self.draw = None
        if args.disable_graphics:
            return
        import cv2
        from PIL import Image, ImageDraw
        fourcc = cv2.VideoWriter_fourcc(*'MP4V')
        fps = self.cap.get(CAP_PROP_FPS) or 15
        self.backbuf = Image.new("RGBA", self.input_size, (0, 0, 0, 0))
        self.draw = ImageDraw.Draw(self.backbuf)
        if args.output_cvat_dir is not None:
            # one image a frame: images/frame_%06d.jpg
            outpath = os.path.join(args.output_cvat_dir, 'images',
                                   'frame_%06d.jpg')
            os.makedirs(os.path.dirname(outpath), exist_ok=True)
            self.output = cv2.VideoWriter(outpath, 0, 0, self.input_size)
        elif args.output:
            self.output = cv2.VideoWriter(args.output, fourcc, fps,
                                          self.input_size)
        self.fontlib = FontLib(self.input_size[0])
        # framebuffer sink (deepdish.py:767-789)
        self.framebufdev = None
        self.framebufres = None
        if args.framebuffer:
            dev = args.framebuffer_device
            fbX = dev[-3:]
            vsizefile = f'/sys/class/graphics/{fbX}/virtual_size'
            if os.path.exists(dev) and os.path.exists(vsizefile):
                w_, h_ = args.framebuffer_width, args.framebuffer_height
                if w_ is None or h_ is None:
                    import re as _re
                    with open(vsizefile) as f:
                        nums = _re.findall('(.*),(.*)', f.read())[0]
                    w_ = w_ or int(nums[0])
                    h_ = h_ or int(nums[1])
                self.framebufdev = dev
                self.framebufres = (w_, h_)
                print(f'Framebuffer device: {dev} resolution: {w_},{h_}')
            else:
                print(f'Invalid framebuffer device: {dev}')

    # ------------------------------------------------------------------
    async def get_cpu_temp(self):
        if not self.cpu_temp_file:
            return None
        try:
            with open(self.cpu_temp_file) as f:
                return float(f.read()) / 1000
        except (OSError, ValueError):
            return None

    def _read_cpu_governor(self):
        """deepdish.py:831-835."""
        if not self.cpu_gov_file:
            return None
        try:
            with open(self.cpu_gov_file) as f:
                return f.read().strip()
        except OSError:
            return None

    async def get_cpu_freq(self):
        if not self.cpu_freq_file:
            return None
        try:
            with open(self.cpu_freq_file) as f:
                return int(f.read())
        except (OSError, ValueError):
            return None

    # ------------------------------------------------------------------
    async def init_mqtt(self):
        args = self.args
        if args.mqtt_broker is None:
            return
        import platform as _platform
        self.mqtt = MQTTClient('deepdish-' + _platform.node(),
                               args.mqtt_broker, args.mqtt_port,
                               username=args.mqtt_user,
                               password=args.mqtt_pass)
        if self.topic is None:
            self.topic = 'default/topic'
        print('Waiting to connect to MQTT broker.')
        await self.mqtt.connect()
        if args.mqtt_verbosity > 1:
            payload = {
                'acp_ts': str(time()), 'acp_event': 'initialisation',
                'acp_id': self.mqtt_acp_id, 'model': args.model,
                'model_class': type(self.detector).__name__,
                'encoder_model': args.encoder_model,
                'encoder_model_class': type(self.encoder).__name__,
                'input': self.input, 'use_edgetpu': False,
                'input_shape': [self.detector.width, self.detector.height],
                'encoder_input_shape': [self.encoder.width,
                                        self.encoder.height],
                'num_threads': args.num_threads,
                'max_age': args.max_age,
                'max_iou_distance': args.max_iou_distance,
                'nms_max_overlap': args.nms_max_overlap,
                'max_cosine_distance': args.max_cosine_distance,
                'background_subtraction':
                    None if args.disable_background_subtraction
                    else args.background_subtraction_ratio,
                'powersaving': None if args.disable_powersaving else
                    (args.powersave_delay_increment,
                     args.powersave_delay_maximum),
                'cpu_governor': self.cpu_governor,
                'object_detector_skip_frames':
                    args.object_detector_skip_frames,
                'interframe_interval': args.interframe_interval,
                'simulate_camera': args.simulate_camera,
            }
            self.mqtt.publish(self.topic, json.dumps(payload))

    def update_payload_with_state(self, payload):
        payload.update(self.counting.counters_payload())

    async def publish_crossing_event(self, t_frame, framenum, crossing_type):
        """deepdish.py:1147-1166."""
        temp = await self.get_cpu_temp()
        if self.mqtt is not None and self.args.mqtt_verbosity > 0:
            payload = {'acp_ts': str(t_frame), 'acp_id': self.mqtt_acp_id,
                       'acp_event': 'crossing',
                       'acp_event_value': crossing_type, 'temp': temp}
            async with self.data_lock:
                self.update_payload_with_state(payload)
            self.mqtt.publish(self.topic, json.dumps(payload))
        if self.log is not None:
            payload = {'timestamp': str(t_frame),
                       'asctime': asctime(localtime(t_frame)),
                       'frame_count': framenum, 'temp': temp}
            async with self.data_lock:
                self.update_payload_with_state(payload)
            with open(self.log, mode='a+') as f:
                f.write(json.dumps(payload) + '\n')

    async def periodic_heartbeat(self):
        """deepdish.py:1168-1185."""
        while True:
            temp = await self.get_cpu_temp()
            if self.mqtt is not None and self.args.mqtt_verbosity > 0:
                payload = {'acp_ts': str(time()),
                           'acp_id': self.mqtt_acp_id,
                           'acp_event': 'heartbeat', 'temp': temp}
                async with self.data_lock:
                    self.update_payload_with_state(payload)
                self.mqtt.publish(self.topic, json.dumps(payload))
            if self.log is not None:
                payload = {'timestamp': str(time()), 'asctime': asctime(),
                           'temp': temp}
                async with self.data_lock:
                    payload['frame_count'] = self.framenum_committed
                    self.update_payload_with_state(payload)
                with open(self.log, mode='a+') as f:
                    f.write(json.dumps(payload) + '\n')
            self._save_checkpoint()
            await asyncio.sleep(self.heartbeat_delay_secs)

    def _save_checkpoint(self):
        if self.args.state_checkpoint:
            save_state(self.args.state_checkpoint, self.state,
                       self.counting.counters_payload(), self.frame_count)

    # ------------------------------------------------------------------
    # Stages
    async def capture(self, q, box):
        """deepdish.py:837-878."""
        last_orig = 0
        try:
            while self.running:
                msg = None
                while msg is None:
                    await asyncio.sleep(0.003)
                    msg = box.get_message()
                    # duplicate-frame guard (deepdish.py:906): without
                    # everyframe sync the capture thread leaves the last
                    # message in the mailbox
                    if msg is not None and msg[0] <= last_orig:
                        msg = None
                    if not self.running:
                        return
                (orig_framenum, frame, t_frame, dt_cap) = msg
                last_orig = orig_framenum
                if self.everyframe:
                    box.set_message(None)
                if frame is None:
                    self.capture_eof = True
                    break
                if self.args.camera_flip:
                    import cv2
                    frame = cv2.flip(frame, 0)
                if frame.shape[1::-1] != self.input_size:
                    import cv2
                    frame = cv2.resize(frame, self.input_size)
                q.put_nowait((orig_framenum, frame, dt_cap, t_frame, time()))
                if self.powersave_delay > 0:
                    await asyncio.sleep(self.powersave_delay)
        finally:
            # the capture thread releases the capture once it sees the stop
            # (a release from here can deadlock against its cap.read())
            self._capstop.set()
            self.kickstart.set()
            if self.everyframe is not None:
                self.everyframe.set()

    async def capture_native(self, q):
        """Offline capture via the native loader: chunks of I420 frames, no
        capture thread, no FreshQueue drops. Runs in place of capture()."""
        chunk = max(1, int(self.args.chunk_size))
        count = 0
        try:
            await self.loop.run_in_executor(None, self.kickstart.wait)
            while self.running:
                frames, counts, total = await self.loop.run_in_executor(
                    None, self.native_loader.next_chunk, chunk)
                n = int(counts[0])
                t_frame = time()
                for j in range(n):
                    count += 1
                    await q.put((count, frames[0, j], 0.0, t_frame, time()))
                if n < chunk or total <= 0:
                    self.capture_eof = True
                    break
        finally:
            self.native_loader.close()

    def _maybe_grow_gallery(self, chunk_len: int):
        """Exact unbounded-gallery parity (reference budget=None,
        deepdish.py:515): before any slot's ring can wrap, double the
        gallery. Bounded by --gallery-max, past which ring reuse begins
        (warned once)."""
        if self.args.disable_gallery_growth:
            return
        if getattr(self, '_gallery_capped_warned', False):
            return   # growth already known unavailable; ring reuse active
        if not self._gallery_growth_ok:
            # live mode: the gallery was pre-sized in __init__; warn once
            # when the ring starts reusing
            if tt.gallery_overflow(self.tracker_cfg, self.state.table):
                self._gallery_capped_warned = True
                print('Live mode: appearance gallery ring reuse began '
                      f'(size {self.tracker_cfg.gallery_size}); oldest '
                      'features overwritten for very long-lived tracks.')
            return
        G = self.tracker_cfg.gallery_size
        pressure = tt.gallery_pressure(self.tracker_cfg, self.state.table)
        # the margin covers the LARGEST possible next batch (a 1-frame tail
        # can be followed by a full chunk)
        margin = max(chunk_len, int(self.args.chunk_size))
        if pressure + margin < G:
            return
        if G >= self.args.gallery_max:
            if not getattr(self, '_gallery_capped_warned', False):
                self._gallery_capped_warned = True
                print(f'Gallery at --gallery-max ({G}); oldest appearance '
                      'features will be overwritten for very long-lived '
                      'tracks (bounded divergence from the unbounded '
                      'reference gallery).')
            return
        new_size = min(max(2 * G, pressure + margin + 1),
                       self.args.gallery_max)
        try:
            self.tracker_cfg, table = tt.grow_gallery(
                self.tracker_cfg, self.state.table, new_size)
        except ValueError as e:
            if not getattr(self, '_gallery_capped_warned', False):
                self._gallery_capped_warned = True
                print(f'Gallery growth unavailable ({e}); continuing with '
                      'the bounded ring.')
            return
        self.framestep = self._make_framestep()
        self.state = PipelineState(table, self.state.bg)
        print(f'Appearance gallery grown to {new_size} features/track '
              '(exact unbounded-gallery parity).')

    def _cvat_step(self, frame_rgb, framenum):
        """Split-mode step with the host annotation merge between NMS and
        encoding (the reference's ordering, deepdish.py:995 -> 1001 ->
        1008). Returns (TrackStepOutput, DetectionSnapshot) of numpy."""
        fs = self.framestep
        frame = np.ascontiguousarray(frame_rgb)
        bg, snap = fs.detect_only(self.state, frame)
        self.state = self.state._replace(bg=bg)
        snap, = to_host(snap)
        valid = snap.valid
        labels = [self.wanted_labels[i] for i in snap.label[valid]]
        bo, lo, so = self.framerec.process_boxes(
            framenum, list(snap.tlwh[valid]), labels,
            list(snap.score[valid]))
        D = self.tracker_cfg.max_detections
        n = min(len(bo), D)
        p_tlwh = np.zeros((D, 4), np.float32)
        p_scores = np.zeros((D,), np.float32)
        p_labels = np.zeros((D,), np.int32)
        p_valid = np.zeros((D,), bool)
        for i in range(n):
            p_tlwh[i] = bo[i]
            p_scores[i] = so[i]
            name = lo[i]
            p_labels[i] = (self.wanted_labels.index(name)
                           if name in self.wanted_labels else 0)
            p_valid[i] = True
        self.state, out_dev, snap2, dets = fs.encode_track(
            self.state, frame, p_tlwh, p_labels, p_scores, p_valid)
        out, snap2 = to_host(out_dev, snap2)
        ids, states = out.track_id, out.state
        self.framerec.link_frame(framenum, ids, out.matched_det)
        self.framerec.link_new_tracks(framenum, ids, states, out.hits)
        slot_det, delmask = self.framerec.tracking_overrides(
            framenum, ids, states, out.time_since_update)
        forced = (slot_det >= 0).any()
        if forced or delmask.any():
            cfg, table = self.tracker_cfg, self.state.table
            if forced:
                table = force_update_slots(
                    cfg, table, torch.from_numpy(slot_det).to(self.device),
                    dets)
            if delmask.any():
                table = delete_slots(
                    cfg, table, torch.from_numpy(delmask).to(self.device))
            self.state = self.state._replace(table=table)
            out, = to_host(out_dev._replace(
                state=table.state,
                time_since_update=table.time_since_update,
                hits=table.hits, track_id=table.track_id,
                tlwh=boxops.xyah_to_tlwh(table.mean[:, :4]),
                label_count=table.label_count,
                label_conf=table.label_conf))
        return out, snap2

    def _device_step(self, frames_rgb):
        """Run the frame step; returns per-frame (TrackStepOutput,
        DetectionSnapshot) pairs of host numpy."""
        if self.framerec is not None:
            return [self._cvat_step(f, self.frame_count + 1 + i)
                    for i, f in enumerate(frames_rgb)]
        if hasattr(self.detector, "detect_host"):
            # scripted detector: host boxes through the frame step
            if self.native_yuv:
                import cv2
                frames_rgb = [cv2.cvtColor(f, cv2.COLOR_YUV2RGB_I420)
                              for f in frames_rgb]
            return [self._scripted_one(f) for f in frames_rgb]
        skip_n = self.args.object_detector_skip_frames or 0
        chunk = max(1, int(self.args.chunk_size))
        if self.native_yuv:
            # frames arrive as I420; full chunks convert on the device
            if len(frames_rgb) == chunk:
                self.state, outs, snaps = self.framestep.run_chunk_yuv(
                    self.state, np.stack(frames_rgb))
                return _per_frame(outs, snaps)
            # partial tail: host-convert and run the single-frame step
            import cv2
            frames_rgb = [cv2.cvtColor(f, cv2.COLOR_YUV2RGB_I420)
                          for f in frames_rgb]
        if len(frames_rgb) != chunk or chunk == 1:
            # The single-frame step, looped: besides chunk == 1 this covers
            # partial batches (live-mode arrival, the EOF tail), as the JAX
            # runtime does; ported as written, since which frames run
            # batched changes the outputs in the last float bits.
            results = []
            for f in frames_rgb:
                frame = np.ascontiguousarray(f)
                if skip_n and self._skip_rem > 0 and \
                        self._prev_raw is not None:
                    # reuse the previous raw detector output
                    # (deepdish.py:929-938)
                    self._skip_rem -= 1
                    self.state, out, snap = self.framestep.step_skip(
                        self.state, frame, self._prev_raw)
                else:
                    self.state, out, snap, raw = self.framestep.step(
                        self.state, frame)
                    self._prev_raw = raw
                    self._skip_rem = skip_n
                results.append(tuple(to_host(out, snap)))
            return results
        self.state, outs, snaps = self.framestep.run_chunk(
            self.state, np.stack(frames_rgb))
        return _per_frame(outs, snaps)

    async def infer(self, q_in, q_out):
        """The frame-step stage (replaces detect_objects + encode_features
        + track_objects)."""
        chunk = max(1, int(self.args.chunk_size))
        # warm-up with a dummy frame (deepdish.py:895-898)
        w, h = self.input_size
        dummy = np.zeros((h, w, 3), np.uint8)
        await self.loop.run_in_executor(None, self._warmup, dummy)
        self.kickstart.set()
        # device-time tracing: the host taxonomy measures wall time; the
        # trace shows where device time goes
        if self.args.profile_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()

        pending = []
        while self.running:
            item = None
            try:
                item = await asyncio.wait_for(q_in.get(), timeout=0.05)
            except asyncio.TimeoutError:
                if not self.capture_eof:
                    continue
                if not pending:
                    # input drained and every frame dispatched: the final
                    # frame number is now exact
                    if self.final_frame is None:
                        self.final_frame = self.frame_count
                    break
            if item is not None:
                if self.everyframe is not None:
                    self.everyframe.set()
                pending.append(item)
                while len(pending) < chunk and not q_in.empty():
                    pending.append(q_in.get_nowait())
                    if self.everyframe is not None:
                        self.everyframe.set()
                offline = (self.everyframe is not None or
                           self.native_loader is not None)
                if len(pending) < chunk and not self.capture_eof \
                        and chunk > 1 and offline:
                    # offline mode fills the chunk before dispatching; live
                    # mode dispatches partial batches immediately
                    continue
            batch, pending = pending, []
            if not batch:
                continue
            t1 = time()
            if self.native_yuv:
                frames_rgb = [f[1] for f in batch]   # I420, device-converted
            else:
                frames_rgb = [f[1][..., ::-1] for f in batch]   # BGR -> RGB
            results = await self.loop.run_in_executor(
                None, self._device_step, frames_rgb)
            self._maybe_grow_gallery(len(frames_rgb))
            t2 = time()
            dt_each = (t2 - t1) / len(batch)
            if self._profiler is not None and \
                    self.frame_count >= self.args.profile_frames:
                self._stop_profiler()
            need_bgr = self.native_yuv and not self.args.disable_graphics
            for (orig_framenum, frame, dt_cap, t_frame, t_q1), (out, snap) \
                    in zip(batch, results):
                if need_bgr:
                    import cv2
                    frame = cv2.cvtColor(frame, cv2.COLOR_YUV2BGR_I420)
                self.frame_count += 1
                framenum = self.frame_count
                elements = [FrameInfo(t_frame, framenum),
                            TimingInfo('Capture latency', 'fcap', dt_cap),
                            TimingInfo('Frame return latency', 'fram',
                                       t1 - t_frame),
                            TimingInfo('Q1 latency', 'q1', t1 - t_q1),
                            TimingInfo('Background subtraction latency',
                                       'bsub', 0.0),
                            TimingInfo('Object detection latency', 'objd',
                                       dt_each),
                            TimingInfo('Q2 latency', 'q2', 0.0),
                            TimingInfo('Image encoding latency', 'ienc',
                                       0.0),
                            TimingInfo('Feature encoding latency', 'feat',
                                       0.0),
                            TimingInfo('Q3 latency', 'q3', 0.0),
                            TimingInfo('Tracker latency', 'trak', 0.0)]
                # powersave ramp (deepdish.py:963-969)
                n_det = int(snap.valid.sum())
                if n_det == 0:
                    self.powersave_delay = min(
                        self.powersave_delay +
                        self.powersave_delay_increment,
                        self.powersave_delay_maximum)
                else:
                    self.powersave_delay = 0
                await q_out.put((framenum, frame, out, snap, elements,
                                 time()))

    def _stop_profiler(self):
        self._profiler.stop()
        os.makedirs(self.args.profile_dir, exist_ok=True)
        path = os.path.join(self.args.profile_dir, 'trace.json')
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f'Wrote the torch.profiler trace to {path}')

    def _scripted_raw_cap(self):
        return max(self.args.max_detections, 32)

    def _scripted_one(self, frame_rgb):
        """One frame via the host script + FrameStep.scripted_step."""
        skip_n = self.args.object_detector_skip_frames or 0
        if skip_n and self._skip_rem > 0 and self._prev_raw is not None:
            # frame-skip semantics (deepdish.py:929-938): reuse the previous
            # host detections, re-run crop/embed + track on this frame
            self._skip_rem -= 1
            boxes, classes, scores = self._prev_raw
        else:
            boxes, classes, scores = self.detector.detect_host(frame_rgb)
            self._prev_raw = (boxes, classes, scores)
            self._skip_rem = skip_n
        R = self._scripted_raw_cap()
        xyxy = np.zeros((R, 4), np.float32)
        cls = np.zeros((R,), np.int32)
        scr = np.zeros((R,), np.float32)
        val = np.zeros((R,), bool)
        for i in range(min(len(boxes), R)):
            x, y, w, h = boxes[i]
            xyxy[i] = (x, y, x + w, y + h)
            cls[i] = max(int(classes[i]), 0)
            scr[i] = scores[i]
            val[i] = classes[i] >= 0
        self.state, out, snap = self.framestep.scripted_step(
            self.state, np.ascontiguousarray(frame_rgb), xyxy, cls, scr, val)
        return tuple(to_host(out, snap))

    def _warmup(self, dummy):
        """Runs the frame-step entry points once on a dummy frame and
        discards the states (so a --state-checkpoint restore is kept), as
        the JAX runtime's compile warm-up does. The tracker writes its
        gallery ring in place, so the warm-up steps a copy of it."""
        table = self.state.table
        state = PipelineState(table._replace(gallery=table.gallery.clone()),
                              self.state.bg)
        if hasattr(self.detector, "detect_host"):
            R = self._scripted_raw_cap()
            self.framestep.scripted_step(
                state, dummy, np.zeros((R, 4), np.float32),
                np.zeros((R,), np.int32), np.zeros((R,), np.float32),
                np.zeros((R,), bool))
            return
        self.framestep.step(state, dummy)
        if int(self.args.chunk_size) > 1:
            state = PipelineState(
                table._replace(gallery=table.gallery.clone()), self.state.bg)
            if self.native_yuv:
                h, w = dummy.shape[0], dummy.shape[1]
                yuv = np.zeros((h * 3 // 2, w), np.uint8)
                frames = np.stack([yuv] * int(self.args.chunk_size))
                self.framestep.run_chunk_yuv(state, frames)
            else:
                frames = np.stack([dummy] * int(self.args.chunk_size))
                self.framestep.run_chunk(state, frames)

    async def process_results(self, q_in, q_out):
        """Counting + element building (deepdish.py:1035-1139)."""
        while self.running:
            (framenum, frame, out, snap, elements, t_prev) = \
                await q_in.get()
            t1 = time()
            events, views = self.counting.process(out)
            async with self.data_lock:
                self.framenum_committed = framenum

            for v in views:
                if v.path is not None:
                    elements.append(TrackedPath(v.path.reshape(-1)))
                annot_mode = self.args.object_annotation.lower()
                annot = str(v.track_id) if annot_mode == 'id' else \
                    (v.label if annot_mode == 'label' else '')
                elements.append(TrackedObject(
                    v.tlbr, annot, v.label, v.confidence, v.track_id,
                    self.trackdata_ratios))
                if self.cam is not None and self.topdownview is not None:
                    bc = np.array([(v.tlbr[0] + v.tlbr[2]) / 2, v.tlbr[3]])
                    pts_pre = self.cam.space_from_image(
                        v.path if v.path is not None else bc[None])
                    pts = (self.topdownview_scalefactors *
                           pts_pre[:, :2]).reshape(-1)
                    elements.append(TopDownObj(self.topdownview, pts))

            t_frame = elements[0].t_frame
            for ev in events:
                elements.append(TrackedPathIntersection(ev.path_tail))
                await self.publish_crossing_event(t_frame, framenum,
                                                  ev.kind)

            dets = snap.tlwh
            for i in np.where(snap.valid)[0]:
                x, y, bw, bh = dets[i]
                elements.append(DetectedObject(
                    np.array([x, y, x + bw, y + bh])))

            if self.topdownview is not None:
                elements.append(TopDownView(self.topdownview))
            elements.append(CountingStats(self.counting.negcount,
                                          self.counting.poscount))
            t2 = time()
            elements.append(TimingInfo('Q3 / Q4 latency', 'q4',
                                       t1 - t_prev))
            elements.append(TimingInfo('Results processing latency',
                                       'proc', t2 - t1))
            await q_out.put((framenum, frame, elements, time()))

    async def render_output(self, q_in):
        """deepdish.py:1240-1301 + graphical_output 1187-1222."""
        import sys
        while self.running:
            try:
                (framenum, frame, elements, t_prev) = await asyncio.wait_for(
                    q_in.get(), timeout=1.0)
            except asyncio.TimeoutError:
                if self.final_frame is not None and \
                        self.framenum_committed >= (self.final_frame or 0):
                    break
                continue
            t1 = time()
            elements.append(TimingInfo('Q5 latency', 'q5', t1 - t_prev))
            elements.append(CameraCountLine(self.cameracountline))

            if not self.args.disable_graphics:
                await self._graphical_output(frame, elements)
            t2 = time()
            elements.append(TimingInfo('Display latency', 'disp', t2 - t1))

            # derived latencies (deepdish.py:1270-1281)
            t_frame = None
            for e in elements:
                if isinstance(e, FrameInfo):
                    t_frame = e.t_frame
                    break
            total = sum(e.delta_t for e in elements
                        if isinstance(e, TimingInfo))
            e2e = t2 - t_frame if t_frame else 0.0
            elements.append(TimingInfo('Sum of latencies', 'sum', total))
            elements.append(TimingInfo('End to end latency', 'e2e', e2e))
            elements.append(TimingInfo('Unaccounted latency', 'miss',
                                       e2e - total))
            if self.t_prev is not None:
                elements.append(TimingInfo('Frame to frame latency', 'f2f',
                                           t2 - self.t_prev))
            self.t_prev = t2

            temp = await self.get_cpu_temp()
            if temp is not None:
                elements.append(TempInfo(temp))
            cpup = self.process.cpu_percent() if self.process else 0.0
            freq = await self.get_cpu_freq()
            elements.append(PipelineInfo(
                0, [q.qsize() for q in self.queues], cpup, freq))

            self._text_output(sys.stdout, elements)
            if self.mqtt is not None and self.args.mqtt_verbosity > 1:
                payload = {}
                for e in elements:
                    if hasattr(e, 'do_json'):
                        e.do_json(payload)
                self.mqtt.publish(self.topic, json.dumps(payload))

            if self.final_frame is not None and \
                    framenum >= self.final_frame:
                break
            if self.args.max_frames is not None and \
                    framenum >= self.args.max_frames:
                self.final_frame = framenum
                break
        self.running = False
        if self.output is not None:
            self.output.release()

    async def _graphical_output(self, frame, elements):
        """deepdish.py:1187-1222."""
        import cv2
        from PIL import Image
        w, h = self.input_size
        self.draw.rectangle([0, 0, w, h], fill=0, outline=0)
        elements.sort(key=lambda e: e.priority)
        image = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGBA))
        render = RenderInfo(1.0, self.fontlib, self.draw, self.backbuf)
        if not self.args.raw_output:
            elements.insert(0, CameraImage(image))
            for e in elements:
                if hasattr(e, 'do_render'):
                    e.do_render(render)
            out_rgba = np.asarray(self.backbuf)
        else:
            out_rgba = np.asarray(image)
        out_bgr = cv2.cvtColor(out_rgba, cv2.COLOR_RGBA2BGR)
        if self.output is not None:
            self.output.write(out_bgr)
        if self.framebufdev is not None:
            try:
                fb = cv2.resize(out_rgba, self.framebufres)
                fb = cv2.cvtColor(fb, cv2.COLOR_RGBA2BGRA)
                with open(self.framebufdev, 'wb') as f:
                    f.write(fb.tobytes())
            except (OSError, cv2.error) as e:
                # a failed write disables the sink (deepdish.py:1216-1221)
                print(f'Framebuffer write failed, disabling: {e}')
                self.framebufdev = None
        if self.args.stream_path:
            ok, enc = cv2.imencode('.jpg', out_bgr)
            if ok:
                tmp = self.args.stream_path + '.tmp'
                with open(tmp, 'wb') as f:
                    f.write(enc.tobytes())
                os.replace(tmp, self.args.stream_path)
        await self.streaminfo.set_frame(out_bgr)

    def _text_output(self, handle, elements):
        for e in elements:
            if isinstance(e, FrameInfo):
                e.do_text(handle, elements)
                break

    # ------------------------------------------------------------------
    async def start(self):
        """deepdish.py:1314-1345."""
        self.running = True
        self.loop = asyncio.get_event_loop()
        if self.native_loader is not None:
            # offline: bounded queue, no frame drops (everyframe semantics)
            chunk = max(1, int(self.args.chunk_size))
            cameraQueue = asyncio.Queue(maxsize=2 * chunk)
            self.everyframe = None
        else:
            cameraQueue = FreshQueue()
        k = self.args.max_queue_size
        inferQueue = asyncio.Queue(maxsize=k)
        resultQueue = asyncio.Queue(maxsize=k)
        self.queues = [cameraQueue, inferQueue, resultQueue]

        render_task = asyncio.ensure_future(self.render_output(resultQueue))
        tasks = [render_task,
                 asyncio.ensure_future(
                     self.process_results(inferQueue, resultQueue)),
                 asyncio.ensure_future(self.infer(cameraQueue, inferQueue))]

        self.kickstart = threading.Event()
        if self.native_loader is None:
            box = MBox()
            ifi = self.args.interframe_interval
            if ifi is not None:
                self.everyframe = None
                ifi_sec = float(ifi) / 1000.0
            else:
                ifi_sec = None
            self._capstop = threading.Event()
            capthread = threading.Thread(
                target=capthread_f,
                args=(self.cap, self.kickstart, box, self.everyframe,
                      ifi_sec, self.simcam, self._capstop), daemon=True)
            capthread.start()
        if self.process:
            self.process.cpu_percent()
        if self.args.streaming:
            self.webserver = MJPEGServer(self.streaminfo,
                                         self.args.streaming_port)
            try:
                await self.webserver.start()
            except OSError as e:
                print(f'Web streaming disabled: {e}')
                self.webserver = None
        if self.native_loader is not None:
            await self.capture_native(cameraQueue)
        else:
            await self.capture(cameraQueue, box)
        await render_task
        self.shutdown()
        for t in tasks:
            t.cancel()

    def shutdown(self):
        """deepdish.py:791-815."""
        self.running = False
        print('Shutting down pipeline.')
        if self._profiler is not None:
            self._stop_profiler()
        self._save_checkpoint()
        if self.args.output_cvat_dir is not None and self.framerec:
            print('Writing CVAT output.')
            os.makedirs(self.args.output_cvat_dir, exist_ok=True)
            tree = self.framerec.xml_output()
            outfile = os.path.join(self.args.output_cvat_dir,
                                   'annotations.xml')
            with open(outfile, 'wb') as f:
                tree.write(f, xml_declaration=True, encoding='utf-8',
                           short_empty_elements=False)
        if self.mqtt:
            if self.args.mqtt_verbosity > 1:
                payload = {'acp_ts': str(time()), 'acp_event': 'shutdown',
                           'acp_id': self.mqtt_acp_id,
                           'model': self.args.model, 'input': self.input}
                self.mqtt.publish(self.topic, json.dumps(payload))
