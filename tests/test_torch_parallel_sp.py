"""The port's TemporalChunkEngine and GridEngine against deepdish_tpu's, on
the CPU.

The temporal engines split one stream's chunk of F = 4 frames over a frame
mesh of two devices (JAX: two of the 8 virtual CPU devices; the port: two
copies of the CPU device); the grid engines run two streams over a (2, 2)
(stream, frame) mesh. The networks, the frames and their margins are those
of tests/test_torch_parallel.py (`build_pair`, `stream_frames`: float32
SSD-MobileNetV1 and MARS from the same numpy seeds on both sides; the
streams are one random image with noise, flipped, rolled and turned).

Held exactly: track ids, states, `matched_det` and the integer-truncated
post-NMS boxes; Kalman means within 1e-4. Also: the state carried across
two chunks equals one 8-frame `FrameStep.run_chunk`, the YUV paths, and
the JAX engines' error messages, word for word. The JAX engines are run
once per module (their `shard_map` compiles are most of the file's
time)."""
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import numpy as np
import torch

from deepdish_tpu.parallel import GridEngine as JGrid
from deepdish_tpu.parallel import TemporalChunkEngine as JTemporal
from deepdish_tpu.parallel import make_grid_mesh as j_grid_mesh
from deepdish_tpu.parallel import make_mesh as j_make_mesh
from deepdish_tpu.pipeline import FrameStep as JFrameStep
from deepdish_tpu.pipeline import FrameStepConfig as JConfig
from deepdish_tpu_torch.parallel import GridEngine as PGrid
from deepdish_tpu_torch.parallel import TemporalChunkEngine as PTemporal
from deepdish_tpu_torch.parallel import make_grid_mesh as p_grid_mesh
from deepdish_tpu_torch.parallel import make_mesh as p_make_mesh
from deepdish_tpu_torch.pipeline import FrameStep as PFrameStep
from deepdish_tpu_torch.pipeline import FrameStepConfig as PConfig
from test_torch_parallel import INTS, H, W, build_pair, stream_frames, \
    to_i420
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

F = 4


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def frames():
    """(4, 8, H, W, 3): two chunks of F frames for each of four streams."""
    return stream_frames(2 * F)


def _assert_same(jres, pres, what):
    """(state, outs, snaps) of a JAX engine against the port's, on the
    same leading axes."""
    (js, jo, jsnap), (ps, po, psnap) = jres, pres
    for name in INTS:
        np.testing.assert_array_equal(getattr(po, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=f"{what} {name}")
    for name in ("valid", "label", "tlwh"):
        np.testing.assert_array_equal(getattr(psnap, name).numpy(),
                                      np.asarray(getattr(jsnap, name)),
                                      err_msg=f"{what} snapshot {name}")
    means = (np.stack([st.table.mean.numpy() for st in ps.streams])
             if hasattr(ps, "streams") else ps.table.mean.numpy())
    np.testing.assert_allclose(means, np.asarray(js.table.mean), atol=1e-4,
                               err_msg=f"{what} Kalman means")
    assert int(psnap.valid.sum()) > 0
    assert int((po.matched_det >= 0).sum()) > 0


# ---- TemporalChunkEngine ----

@pytest.fixture(scope="module")
def temporal(pair):
    jfs, pfs = pair
    return (JTemporal(jfs, mesh=j_make_mesh(2, axis_name="frame")),
            PTemporal(pfs, mesh=p_make_mesh(2, "frame", device="cpu")))


@pytest.fixture(scope="module")
def temporal_runs(pair, temporal, frames):
    """Two chunks of stream 0 through both engines, carrying the state,
    and the first chunk's I420 through both YUV paths."""
    (jfs, pfs), (je, pe) = pair, temporal
    out = {}
    for name, fs, eng in (("jax", jfs, je), ("port", pfs, pe)):
        state, chunks = fs.init_state(), []
        for k in range(2):
            state, outs, snaps = eng.run_chunk(
                state, frames[0, k * F:(k + 1) * F])
            chunks.append((state, outs, snaps))
        yuv = eng.run_chunk_yuv(fs.init_state(), to_i420(frames[1, :F]))
        out[name] = (chunks, yuv)
    return out


@pytest.mark.timeout(300)
def test_temporal_matches_jax(temporal_runs):
    (jchunks, jyuv), (pchunks, pyuv) = (temporal_runs["jax"],
                                        temporal_runs["port"])
    for k in range(2):
        _assert_same(jchunks[k], pchunks[k], f"chunk {k}")
    _assert_same(jyuv, pyuv, "yuv")


@pytest.mark.timeout(300)
def test_temporal_state_carries_across_chunks(pair, temporal_runs, frames):
    """Two chunks of the port's engine == one 8-frame single-device
    `run_chunk`, and the YUV path == `run_chunk_yuv`."""
    _, pfs = pair
    pchunks, pyuv = temporal_runs["port"]
    state, outs, snaps = pfs.run_chunk(pfs.init_state(), frames[0])
    for name in INTS:
        got = torch.cat([getattr(c[1], name) for c in pchunks])
        np.testing.assert_array_equal(got.numpy(),
                                      getattr(outs, name).numpy())
    got = torch.cat([c[2].tlwh for c in pchunks])
    np.testing.assert_array_equal(got.numpy(), snaps.tlwh.numpy())
    for a, b in zip(pchunks[1][0].table, state.table):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    _, youts, _ = pfs.run_chunk_yuv(pfs.init_state(), to_i420(frames[1, :F]))
    for name in INTS:
        np.testing.assert_array_equal(getattr(pyuv[1], name).numpy(),
                                      getattr(youts, name).numpy())


# ---- GridEngine ----

@pytest.fixture(scope="module")
def grid(pair):
    jfs, pfs = pair
    return (JGrid(jfs, n_streams=2, mesh=j_grid_mesh(2, 2)),
            PGrid(pfs, n_streams=2, mesh=p_grid_mesh(2, 2, device="cpu")))


@pytest.fixture(scope="module")
def grid_runs(grid, frames):
    """Streams 2 and 3, two chunks through both grid engines, carrying the
    states, and the first chunk's I420 through both YUV paths."""
    out = {}
    for name, eng in zip(("jax", "port"), grid):
        states, chunks = eng.init_states(), []
        for k in range(2):
            states, outs, snaps = eng.run_chunk(
                states, frames[2:, k * F:(k + 1) * F])
            chunks.append((states, outs, snaps))
        yuv = eng.run_chunk_yuv(eng.init_states(), to_i420(frames[2:, :F]))
        out[name] = (chunks, yuv)
    return out


@pytest.mark.timeout(300)
def test_grid_matches_jax(grid_runs):
    (jchunks, jyuv), (pchunks, pyuv) = grid_runs["jax"], grid_runs["port"]
    for k in range(2):
        _assert_same(jchunks[k], pchunks[k], f"chunk {k}")
    _assert_same(jyuv, pyuv, "yuv")


@pytest.mark.timeout(300)
def test_grid_equals_run_chunk_per_stream(pair, grid, grid_runs, frames):
    """Per stream, two grid chunks == one 8-frame `run_chunk`; each
    stream's state lives on its row's first device."""
    _, pfs = pair
    _, pe = grid
    pchunks, _ = grid_runs["port"]
    for s in range(2):
        state, outs, _ = pfs.run_chunk(pfs.init_state(), frames[2 + s])
        for name in INTS:
            got = torch.cat([getattr(c[1], name)[s] for c in pchunks])
            np.testing.assert_array_equal(got.numpy(),
                                          getattr(outs, name).numpy())
        final = pchunks[1][0].stream(s)
        for a, b in zip(final.table, state.table):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        assert final.table.mean.device == pe.mesh.devices[s, 0]


# ---- errors: the JAX messages, word for word ----

def _messages(calls):
    """The ValueError message of each call."""
    out = []
    for call in calls:
        with pytest.raises(ValueError) as e:
            call()
        out.append(str(e.value))
    return out


@pytest.mark.timeout(120)
def test_errors_match_jax(pair, temporal, grid, frames):
    (jfs, pfs), (jt, pt), (jg, pg) = pair, temporal, grid
    j = _messages([
        lambda: jt.run_chunk(jfs.init_state(), frames[0, :3]),
        lambda: jg.run_chunk(jg.init_states(), frames[2:, :3]),
        lambda: jg.run_chunk(jg.init_states(), frames[:, :F]),
        lambda: jg.run_chunk(jg.init_states(), frames[2:, 0]),
        lambda: JGrid(jfs, n_streams=3, mesh=j_grid_mesh(2, 2)),
        lambda: JGrid(jfs, n_streams=2, mesh=j_make_mesh(4))])
    p = _messages([
        lambda: pt.run_chunk(pfs.init_state(), frames[0, :3]),
        lambda: pg.run_chunk(pg.init_states(), frames[2:, :3]),
        lambda: pg.run_chunk(pg.init_states(), frames[:, :F]),
        lambda: pg.run_chunk(pg.init_states(), frames[2:, 0]),
        lambda: PGrid(pfs, n_streams=3, mesh=p_grid_mesh(2, 2, device="cpu")),
        lambda: PGrid(pfs, n_streams=2, mesh=p_make_mesh(4, device="cpu"))])
    assert "multiple of the mesh size" in p[0]
    assert "missing the 'frame' axis" in p[5]
    assert p == j


@pytest.mark.timeout(120)
def test_bgsub_rejected_like_jax(pair):
    jfs, pfs = pair
    jbg = JFrameStep(jfs.detector, jfs.encoder, jfs.tracker_cfg,
                     jfs.wanted_labels, (H, W),
                     JConfig(background_subtraction=True))
    pbg = PFrameStep(pfs.detector, pfs.encoder, pfs.tracker_cfg,
                     pfs.wanted_labels, (H, W),
                     PConfig(background_subtraction=True), device="cpu")
    j = _messages([
        lambda: JTemporal(jbg, mesh=j_make_mesh(2, axis_name="frame")),
        lambda: JGrid(jbg, n_streams=2, mesh=j_grid_mesh(2, 2))])
    p = _messages([
        lambda: PTemporal(pbg, mesh=p_make_mesh(2, "frame", device="cpu")),
        lambda: PGrid(pbg, n_streams=2,
                      mesh=p_grid_mesh(2, 2, device="cpu"))])
    assert all("background" in m for m in p)
    assert p == j


def test_temporal_axis_name_fallback(pair, frames):
    """A mesh without the 'frame' axis: the engine splits along the mesh's
    first axis, as the JAX engine does; a 2-D mesh's second axis repeats
    the work, so its first column takes the shards."""
    _, pfs = pair
    eng = PTemporal(pfs, mesh=p_make_mesh(2, "stream", device="cpu"))
    assert eng.n_devices == 2
    from deepdish_tpu_torch.parallel.multistream import Mesh
    eng2 = PTemporal(pfs, mesh=Mesh([["cpu"] * 3] * 2, ("stream", "x")))
    assert eng2.n_devices == 2
    want = eng.run_chunk(pfs.init_state(), frames[0, :F])
    got = eng2.run_chunk(pfs.init_state(), frames[0, :F])
    for a, b in zip(want[1], got[1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.timeout(120)
def test_grid_mesh_needs_the_cards(monkeypatch):
    """Without `device`, a mesh takes distinct cards: one card present and
    four asked for raises with the JAX message's words."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            p_grid_mesh(2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError) as e:
        p_grid_mesh(2, 2)
    assert str(e.value) == "need 4 devices for a (2, 2) grid, have 1"
    with pytest.raises(ValueError) as e:
        j_grid_mesh(4, 4)
    assert str(e.value) == "need 16 devices for a (4, 4) grid, have 8"
