"""The port's measuring tools on the CPU: deepdish_tpu_torch.tools.bench
(bench.py's three modes) and tools.profile_components.

At a toy size (96x128 frames, the random-init SSD-MobileNetV1 and MARS of
the registry, tracker T = 8, D = 4, every COCO label wanted so that every
frame has detections) each mode runs under `--device cpu` through `main`
and prints one JSON line: its keys, finite numbers, `"platform": "cpu"`
with no device name, and bench.ROUNDS timed units, each rate's median
beside its whole-window rate. The synthetic frames are
held to bench.py's formulas at 720p, the chunked mode's track ids to a
direct `run_chunk_yuv` loop, and profile_components' stages to run_chunk's
own. Without a card, or without the native loader for an mp4 source, the
tools raise."""
import json
import math

import numpy as np
import pytest
import torch

from deepdish_tpu_torch.models import COCO_LABELS
from deepdish_tpu_torch.tools import bench
from deepdish_tpu_torch.tools import profile_components as pc
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

H, W = 96, 128
TRACKER = dict(max_tracks=8, max_detections=4, gallery_size=8,
               num_labels=len(COCO_LABELS))
ROUNDS = bench.ROUNDS


@pytest.fixture(scope="module")
def fs():
    return bench.build_framestep(device="cpu", height=H, width=W,
                                 tracker=TRACKER, enc_cap=4,
                                 wanted=COCO_LABELS)


def _numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert sum(1 for o in out if o.startswith("{")) == 1
    return line


MODES = {
    "latency": ["--latency", "--steps", "4"],
    "chunked": ["--chunk", "2", "--frames", "2", "--reps", "1"],
    "chunked_seq": ["--chunk", "2", "--frames", "2", "--reps", "1",
                    "--seq-decode"],
    "streams": ["--streams", "2", "--stream-chunk", "1", "--reps", "1"],
    "streams_e2e": ["--streams", "2", "--stream-chunk", "1", "--reps", "1",
                    "--e2e", "--frames", "1"],
}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_prints_one_json_line(fs, mode, capsys, tmp_path):
    """chunked and --streams --e2e decode an mp4 through the native loader
    (this box builds it). The chunked mode decodes with whichever of the
    sequential and the striped decoder measured faster (bench.py's rule),
    so its source is checked against that rule, not one outcome of the
    race; --seq-decode always takes the sequential one."""
    argv = MODES[mode] + ["--video-dir", str(tmp_path)]
    got = bench.main(argv, framestep=fs)
    line = _last_json(capsys)
    assert line == json.loads(json.dumps(got))
    for key in ("metric", "value", "unit", "vs_baseline", "stat", "frames",
                "host_syncs_per_frame", "lsap_launches_per_frame",
                "warmup_s", "platform", "device"):
        assert key in line, key
    assert line["platform"] == "cpu"
    assert line["device"] == {"name": None, "count": 0,
                              "power_limit_w": None}
    nums = list(_numbers(line))
    assert nums and all(math.isfinite(v) for v in nums)
    assert line["host_syncs_per_frame"] > 0
    assert line["lsap_launches_per_frame"] == 0   # plain version on the CPU
    if mode == "latency":
        for leg in ("resident_ms", "e2e_ms"):
            assert line[leg]["n"] == 4
            assert line[leg]["p50"] <= line[leg]["p99"] <= line[leg]["max"]
        assert line["frames"] == 8 and line["dets_per_frame"] > 0
        return
    assert len(line["value_rounds"]) >= 1
    assert line["value_min"] <= line["value"] <= line["value_max"]
    resident = "value" if mode == "streams" else "device_resident_fps"
    assert line["rounds"] == ROUNDS
    assert len(line[f"{resident}_rounds"]) == ROUNDS
    for key in ("value", resident):   # all frames over all seconds
        rates = line[f"{key}_rounds"]
        window = len(rates) / sum(1 / r for r in rates)
        assert line[f"{key}_window"] == pytest.approx(window, rel=1e-9)
        assert line[f"{key}_min"] <= window <= line[f"{key}_max"]
    if mode.startswith("chunked"):
        seq = (mode == "chunked_seq"
               or line["decode_striped_fps"] <= line["decode_only_fps"])
        assert line["source"] == ("mp4-native-decode" if seq
                                  else "mp4-striped-decode-x4")
        assert line["decode_stripes"] == (1 if seq else 4)
        assert line["decode_only_fps"] > 0 and line["e2e_model_fps"] > 0
        assert line["transfer_ceiling_fps_rounds"].__len__() == ROUNDS
    if mode == "streams":
        assert line["streams"] == 2 and line["frames"] == 2 * ROUNDS
        assert line["dets_per_frame"] > 0
    if mode == "streams_e2e":
        assert line["decode_only_fps"] > 0 and line["frames"] == 2


def test_rate_window_is_all_frames_over_all_seconds():
    """One slow unit moves the window rate and leaves the median."""
    line = bench.rate("fps", 32, [0.1, 0.1, 0.1, 0.1, 1.6])
    assert line["fps"] == pytest.approx(320.0)
    assert line["fps_min"] == pytest.approx(20.0)
    assert line["fps_window"] == pytest.approx(80.0)   # 160 frames, 2 s
    assert len(line["fps_rounds"]) == 5


def test_synthetic_frames_are_bench_formulas():
    """bench.py:270-277, :594-603 and :358-362 rebuilt here, at 720p."""
    h, w = 720, 1280
    rng = np.random.RandomState(0)
    base = rng.randint(0, 80, size=(h, w, 3)).astype(np.uint8)
    assert np.array_equal(bench.base_image(h, w), base)
    for i in (0, 1, 7, 130):                         # --latency
        f = base.copy()
        x = (40 + i * 9) % (w - 200)
        f[200:500, x:x + 160] = 230
        assert np.array_equal(bench.latency_frame(base, i), f)
    chunk = 3
    src = bench.SyntheticSource(chunk, 12, h, w, use_yuv=False)
    for i in (0, 2, 19):                             # chunked
        frames = np.zeros((chunk, h, w, 3), np.uint8)
        for j in range(chunk):
            f = base.copy()
            x = (40 + (i * chunk + j) * 24) % (w - 200)
            f[200:500, x:x + 160] = 230
            frames[j] = f
        assert np.array_equal(src.chunk_at(i), frames)
    assert src.next_chunk(3) is not None and src.next_chunk(4) is None
    yuv = bench.SyntheticSource(chunk, 12, h, w, use_yuv=True)
    assert np.array_equal(yuv.chunk_at(2), bench.to_i420(src.chunk_at(2)))
    n_streams, chunk = 3, 2                          # --streams
    frames = np.zeros((n_streams, chunk, h, w, 3), np.uint8)
    for s in range(n_streams):
        for k in range(chunk):
            f = base.copy()
            x = (40 + s * 60 + k * 9) % (w - 200)
            f[200:500, x:x + 160] = 230
            frames[s, k] = f
    assert np.array_equal(bench.stream_frames(n_streams, chunk, h, w),
                          frames)


def test_i420_is_bt601():
    """The numpy conversion on flat colours: BT.601 video range."""
    rgb = np.zeros((1, 4, 4, 3), np.uint8)
    rgb[..., 0] = 255                                  # red
    out = bench.to_i420(rgb)
    assert out.shape == (1, 6, 4)
    assert (out[0, :4] == 82).all()                    # Y
    assert (out[0, 4, :2] == 90).all()                 # U
    assert (out[0, 5, 2:] == 240).all()                # V


@pytest.mark.timeout(120)
def test_chunked_track_ids_equal_run_chunk_loop(fs):
    """The decode -> count loop (synthetic I420, depth 2) ends on the
    track ids of run_chunk_yuv over the same chunks from a fresh state."""
    chunk, total = 2, 4
    _, detail = bench.bench_chunked(fs, chunk=chunk, total_frames=total,
                                    reps=1, synthetic=True)
    src = bench.SyntheticSource(chunk, total, H, W, use_yuv=True)
    state = fs.init_state()
    for i in range(total // chunk):
        state, outs, snaps = fs.run_chunk_yuv(state, src.chunk_at(i))
    assert int(snaps.valid.sum()) > 0
    np.testing.assert_array_equal(detail["track_id"], outs.track_id.numpy())


@pytest.mark.timeout(120)
def test_profile_components(fs, capsys):
    """The JSON line carries the eight figures and the profiler split, and
    the det+NMS and crop+MARS stages give run_chunk's own outputs."""
    got = pc.main(["--chunk", "2", "--reps", "1"], framestep=fs)
    line = _last_json(capsys)
    assert line == json.loads(json.dumps(got))
    assert set(line["figures_ms_per_frame"]) == set(pc.FIGURES)
    assert line["platform"] == "cpu" and line["device"]["name"] is None
    assert line["idle_share"] is None                 # no device here
    assert "framestep.tracker" in line["stage_host_ms_per_frame"]
    assert all(math.isfinite(v) for v in _numbers(
        {k: v for k, v in line.items() if k != "idle_share"}))
    frames = torch.from_numpy(bench.SyntheticSource(2, 2, H, W, False)
                              .chunk_at(0))
    _, out = pc.components(fs, frames, reps=1)
    with torch.inference_mode():
        dets, snaps = fs._detect_encode_frames(frames)
    assert int(snaps.valid.sum()) > 0
    for a, b in zip(out["snaps"], snaps):
        assert torch.equal(a, b)
    assert torch.equal(out["feats"], dets.feature[:, :fs._enc_cap])


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: bench.main(["--latency"]),
                 lambda: bench.main([]),
                 lambda: pc.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_mp4_source_without_loader_raises(fs, monkeypatch, tmp_path):
    from deepdish_tpu_torch.parallel import MultiStreamEngine, make_mesh
    from deepdish_tpu_torch.utils import native
    monkeypatch.setattr(native, "load_library", lambda: None)
    monkeypatch.setattr(bench.shutil, "which", lambda name: None)
    eng = MultiStreamEngine(fs, 2, make_mesh(1, device="cpu"))
    for call in (lambda: bench.bench_chunked(fs, chunk=2, total_frames=2,
                                             video_dir=str(tmp_path)),
                 lambda: bench.bench_streams_e2e(eng, chunk=1,
                                                 total_frames=1,
                                                 video_dir=str(tmp_path))):
        with pytest.raises(RuntimeError,
                           match="native frame loader.*g\\+\\+.*--synthetic"):
            call()
    assert not list(tmp_path.iterdir())               # nothing written
