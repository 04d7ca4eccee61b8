"""The port's CLI against the JAX package's with SSD-MobileNetV1 and MARS
from .npz files of JAX random-init variables (float32 on both sides), on
the CPU: 160x120, 10 frames of a drifting texture, background subtraction
on, --chunk-size 1 (the single-frame step) and 4 (the native loader's I420
chunks through `run_chunk_yuv`, the 2-frame tail through the single-frame
step), --gallery-size 8 so that gallery growth fires. Identical as in
tests/test_torch_pipeline.py: counters, and per frame framenum, track ids,
labels and detection boxes; track boxes within 1 px, confidences within
1e-5 relative."""
import asyncio

import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")

from deepdish_tpu_torch.models import COCO_LABELS
from test_torch_pipeline import (COMMON, RecordingMQTT, _compare, _frames,
                                 _last_counters, _texture_scene, _write_video,
                                 f32_jax, j_amain, p_amain, weights)

__all__ = ["f32_jax", "weights"]   # fixtures used below


@pytest.mark.timeout(300)
@pytest.mark.parametrize("chunk", [1, 4])
def test_cli_ssd_mars_matches_jax(tmp_path, weights, f32_jax, chunk,
                                  capsys):
    video = tmp_path / "texture.mp4"
    _write_video(video, _texture_scene())
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video), "--model", weights["ssd"],
                           "--encoder-model", weights["mars"],
                           "--wanted-labels", ",".join(COCO_LABELS),
                           "--score-threshold", "0.3", "--gallery-size", "8",
                           "--chunk-size", str(chunk), "--log", str(log)]
                          + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    printed = capsys.readouterr().out
    n_tracks, n_dets = _compare(*pays)
    assert len(_frames(pays[1])) == 10
    assert _last_counters(logs[1]) == _last_counters(logs[0])
    assert n_tracks > 0 and n_dets > 0
    # both CLIs grew the gallery past --gallery-size
    assert printed.count("Appearance gallery grown to 16") == 2
