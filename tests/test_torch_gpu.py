"""Tests of the port that need a CUDA card: the hand-written LSAP kernel
against its plain version and scipy, the fused depthwise-separable kernel
against its plain version, their wrappers' checks, the tracker, the
MOG2 background subtraction and the frame step on the card against the
CPU, the 16-stream engine's batched tracker against its streams alone, the quantized paths' exact integer contractions and executor on
the card against the CPU, tools/probe_int8.py's int8 steps card == CPU
and the w8a8 MARS's two int8 contractions (impl dot and conv) equal on
the card. They skip without a card, and
import nothing of JAX. On the GPU machine:

    python -m pytest -m gpu tests/test_torch_*.py

and where JAX is not installed add --noconftest (tests/conftest.py
configures JAX); the JAX parity files then skip at import."""
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from deepdish_tpu_torch.ops.assignment import solve_lsap_plain
from deepdish_tpu_torch.ops.dsconv import dsconv_plain, reorder_tolerance

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepdish_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _pad(cost, k):
    out = np.full((k, k), 7e7, np.float32)
    out[:cost.shape[0], :cost.shape[1]] = cost
    return out


def _scipy(cost, k):
    want = np.full((k,), -1, np.int32)
    if cost.size:
        rows, cols = linear_sum_assignment(cost.astype(np.float64))
        want[rows] = cols
    return want


def test_lsap_kernel_matches_plain_and_scipy(cuda):
    """Every lane layout of the warp-per-matrix kernel (Q = 1, 2, 3, 4 and
    the largest, with K on both sides of a 32-column boundary), one call a
    K over 40 clamped matrices of any shape, and two batches of more
    one-warp blocks than the card has SMs."""
    from deepdish_tpu_torch.kernels import lsap
    rng = np.random.RandomState(1)
    cap = lsap.max_capacity()
    for k, n in ((1, 40), (8, 40), (31, 40), (32, 40), (33, 40), (64, 40),
                 (65, 40), (128, 12), (cap, 4), (8, 301), (64, 290)):
        cases = []
        for _ in range(n):
            r, c = rng.randint(0, k + 1), rng.randint(0, k + 1)
            cost = rng.uniform(0, 0.4, size=(r, c)).astype(np.float32)
            cost[cost > 0.2] = np.float32(0.2 + 1e-5)
            cases.append(cost)
        costs = torch.tensor(np.stack([_pad(c, k) for c in cases]),
                             device=cuda)
        sizes = torch.tensor([c.shape for c in cases], dtype=torch.int32,
                             device=cuda)
        before = lsap.launches
        got = lsap.solve(costs, sizes).cpu().numpy()
        assert lsap.launches == before + 1
        np.testing.assert_array_equal(
            got, solve_lsap_plain(costs.cpu(), sizes.cpu()).numpy())
        for i, c in enumerate(cases):
            np.testing.assert_array_equal(got[i], _scipy(c, k))


def test_lsap_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    from deepdish_tpu_torch.kernels import lsap
    costs = torch.zeros((2, 8, 8), device=cuda)
    sizes = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    before = lsap.launches
    with pytest.raises(TypeError):
        lsap.solve(costs.double(), sizes)
    with pytest.raises(TypeError):
        lsap.solve(costs, sizes.long())
    with pytest.raises(ValueError):
        lsap.solve(costs[:, :, :4], sizes)
    with pytest.raises(ValueError):
        lsap.solve(costs.transpose(1, 2), sizes)
    with pytest.raises(ValueError):
        lsap.solve(costs.cpu(), sizes)
    cap = lsap.max_capacity()
    assert cap >= 236          # what the block-per-matrix design took
    k = cap + 1
    with pytest.raises(ValueError):
        lsap.solve(torch.zeros((1, k, k), device=cuda), sizes[:1])
    assert lsap.launches == before


def test_tracker_card_matches_cpu(cuda):
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.kernels import lsap
    rng = np.random.RandomState(2)
    cfg = tt.TrackerConfig(max_tracks=16, max_detections=8, feature_dim=32,
                           gallery_size=16, num_labels=2, max_age=5)
    pos = rng.uniform(100, 400, (6, 2))
    vel = rng.uniform(-6, 6, (6, 2))
    feats = rng.normal(size=(6, 32))
    tables = [tt.create_table(cfg, cuda), tt.create_table(cfg, "cpu")]
    before = lsap.launches
    for _ in range(30):
        pos += vel
        keep = rng.uniform(size=6) > 0.1
        boxes = np.c_[pos + rng.normal(0, 1, pos.shape), np.full((6, 2), 40.0)]
        cols = (boxes[keep], np.full(keep.sum(), 0.9), np.arange(6)[keep] % 2,
                (feats + rng.normal(0, 0.05, feats.shape))[keep])
        outs = []
        for i, where in enumerate((cuda, "cpu")):
            tables[i], out = tt.step(cfg, tables[i],
                                     tt.pack_detections(cfg, *cols,
                                                        device=where))
            outs.append(out)
        for name in ("track_id", "state", "matched_det", "deleted_id"):
            np.testing.assert_array_equal(getattr(outs[0], name).cpu().numpy(),
                                          getattr(outs[1], name).numpy())
    assert lsap.launches > before


def test_framestep_on_the_card(cuda):
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import (COCO_LABELS, create_box_encoder,
                                           create_detector)
    from deepdish_tpu_torch.pipeline import FrameStep
    det = create_detector("ssd_mobilenet", device=cuda,
                          generator=torch.Generator().manual_seed(0))
    enc = create_box_encoder("mars", device=cuda,
                             generator=torch.Generator().manual_seed(1))
    cfg = tt.TrackerConfig(max_tracks=16, max_detections=8,
                           gallery_size=32, num_labels=len(COCO_LABELS))
    fs = FrameStep(det, enc, cfg, COCO_LABELS, (96, 128), device=cuda)
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (96, 128, 3))
    frames = np.clip(base[None] + rng.randint(-4, 5, (6, 96, 128, 3)), 0,
                     255).astype(np.uint8)
    before = lsap.launches
    state = fs.init_state()
    for f in frames:
        state, out, snap, _ = fs.step(state, f)
    state2, outs, snaps = fs.run_chunk(fs.init_state(), frames)
    torch.cuda.synchronize()
    assert lsap.launches > before
    assert int(snap.valid.sum()) > 0
    assert outs.track_id.shape == (6, 16) and snaps.tlwh.shape == (6, 8, 4)
    assert bool(torch.isfinite(outs.tlwh).all())
    assert (state.table.state != 0).any() and (state2.table.state != 0).any()


def test_bgsub_card_matches_cpu(cuda):
    """MOG2 on the card against the CPU on a scene whose static background
    leaves most of the 5 components a pixel at zero weight (the sort's
    ties): masks agree on >= 0.999 of the pixels every frame, the state
    within 1e-4; the frame-1 black-pixel rule and the moving block's
    foreground hold on both."""
    from deepdish_tpu_torch.ops import bgsub
    rng = np.random.RandomState(8)
    h, w = 120, 160
    base = rng.randint(40, 80, (h, w, 3)).astype(np.uint8)
    states = [bgsub.init_state(h, w, cuda), bgsub.init_state(h, w, "cpu")]
    for i in range(40):
        f = np.clip(base + rng.randint(-3, 4, base.shape), 0,
                    255).astype(np.uint8)
        if i == 0:
            f[:8, :8] = 0
        if i >= 20:
            f[30:70, 10 + 3 * i:40 + 3 * i] = 220
        masks = []
        for n, dev in enumerate((cuda, "cpu")):
            states[n], m = bgsub.update(states[n],
                                        torch.from_numpy(f).to(dev))
            masks.append(m.cpu().numpy())
        assert (masks[0] == masks[1]).mean() >= 0.999, i
        if i == 0:
            assert (masks[0][:8, :8] == 255).all()
    assert (masks[0][30:70, 10 + 3 * 39:40 + 3 * 39] == 255).mean() > 0.5
    for a, b in zip(states[0], states[1]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


def _dsconv_args(rng, b, h, w, cin, cout, dtype, device):
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return (f32(rng.standard_normal((b, h, w, cin))).to(dtype),
            f32(rng.standard_normal((3, 3, cin)) * 0.2),
            f32(rng.random(cin) + 0.5), f32(rng.standard_normal(cin) * 0.1),
            f32(rng.standard_normal((cin, cout)) * 0.2),
            f32(rng.random(cout) + 0.5), f32(rng.standard_normal(cout) * 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_dsconv_kernel_matches_plain(cuda, stride, dtype):
    """f32 within the JAX kernel test's atol 2e-5 / rtol 1e-5; bf16 within
    the bound on reordering the f32 pointwise sum (the only difference);
    and the intermediate bit-equal: with an identity pointwise
    kernel, unit scale and zero bias the output is the rounded intermediate
    itself. The shapes take every path of the bf16 kernel: ds13 and ds7 at
    batch 1 (K split across blocks), Cin = Cout = 8 (K and N zero-padded),
    Cin = 40 (a slice of 5 channel chunks), Cin = 12 (not a multiple of 8:
    scalar taps), Cout = 130 (scalar weight rows), M not a multiple of the
    64-pixel tile."""
    from deepdish_tpu_torch.kernels import dsconv
    rng = np.random.default_rng(4 + stride)
    for b, h, w, cin, cout in [(2, 10, 12, 8, 16), (2, 11, 13, 8, 16),
                               (2, 9, 9, 16, 8), (1, 75, 75, 40, 72),
                               (2, 19, 19, 96, 130), (1, 10, 10, 1024, 1024),
                               (1, 19, 19, 512, 512), (1, 9, 9, 8, 8),
                               (3, 7, 7, 12, 24)]:
        a = _dsconv_args(rng, b, h, w, cin, cout, dtype, cuda)
        before = dsconv.launches
        got = dsconv.fused(*a, stride=stride)
        torch.cuda.synchronize()
        assert dsconv.launches == before + 1
        want = dsconv_plain(*a, stride=stride)
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
        else:
            tol = reorder_tolerance(got, want, *a, stride=stride)
            assert bool(((got.float() - want.float()).abs() <= tol).all())
        ident = (a[0], a[1], a[2], a[3],
                 torch.eye(cin, device=cuda), torch.ones(cin, device=cuda),
                 torch.zeros(cin, device=cuda))
        assert torch.equal(dsconv.fused(*ident, stride=stride),
                           dsconv_plain(*ident, stride=stride))


def test_dsconv_bf16_launch_plans_agree(cuda):
    """The bf16 kernel under every block width and several K splits, on a
    shape whose default plan uses neither 256 nor a split: each within the
    reorder tolerance of the plain version, one counted launch per call."""
    from deepdish_tpu_torch.kernels import dsconv
    rng = np.random.default_rng(7)
    a = _dsconv_args(rng, 2, 19, 19, 96, 300, torch.bfloat16, cuda)
    want = dsconv_plain(*a, stride=1)
    m = 2 * 19 * 19
    for block_n in (64, 128, 256):
        for k_chunk in (16, 48, 96):
            before = dsconv.launches
            got = dsconv.fused(*a, stride=1, launch_plan=dsconv.Plan(
                m, 300, 96, block_n, k_chunk))
            torch.cuda.synchronize()
            assert dsconv.launches == before + 1
            tol = reorder_tolerance(got, want, *a, stride=1)
            assert bool(((got.float() - want.float()).abs() <= tol).all())
    with pytest.raises(ValueError):
        dsconv.fused(*a, stride=1,
                     launch_plan=dsconv.Plan(m, 300, 96, 128, 24))


def test_dsconv_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    from deepdish_tpu_torch.kernels import dsconv
    a = _dsconv_args(np.random.default_rng(0), 1, 6, 6, 8, 16,
                     torch.float32, cuda)
    before = dsconv.launches
    with pytest.raises(ValueError):
        dsconv.fused(*a, stride=3)
    with pytest.raises(TypeError):
        dsconv.fused(a[0].half(), *a[1:])
    with pytest.raises(TypeError):
        dsconv.fused(a[0], a[1], a[2].double(), *a[3:])
    with pytest.raises(ValueError):
        dsconv.fused(a[0][0], *a[1:])
    with pytest.raises(ValueError):
        dsconv.fused(a[0], a[1][:, :, :4], *a[2:])
    with pytest.raises(ValueError):
        dsconv.fused(a[0], *a[1:4], a[4][:4], *a[5:])
    with pytest.raises(ValueError):
        dsconv.fused(a[0].transpose(1, 2), *a[1:])
    with pytest.raises(ValueError):
        dsconv.fused(a[0].cpu(), *a[1:])
    assert dsconv.launches == before


def test_exact_integer_contractions_on_the_card(cuda):
    """The quantized paths' contractions: torch._int_mm (int8 weights
    column-major, rows padded past 16, K and N padded to multiples of 8)
    and the float64 matmul equal the CPU's exact products, at shapes that
    need every padding."""
    from deepdish_tpu_torch.models.qgraph import (int8_matmul, int8_weight,
                                                  wide_matmul, wide_weight)
    rng = np.random.RandomState(3)
    for m, k, n in ((1, 3, 5), (16, 27, 32), (17, 288, 45), (300, 1024, 91)):
        a = rng.randint(-128, 128, (m, k)).astype(np.int8)
        w = rng.randint(-127, 128, (k, n)).astype(np.int8)
        want = a.astype(np.int64) @ w.astype(np.int64)
        got = int8_matmul(torch.from_numpy(a).to(cuda),
                          int8_weight(w, cuda), n)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        aw = rng.randint(-255, 256, (m, k))
        ww = rng.randint(-255, 256, (k, n))
        got = wide_matmul(torch.from_numpy(aw).to(cuda), wide_weight(ww, cuda))
        np.testing.assert_array_equal(got.cpu().numpy(), aw @ ww)


def test_flop_counts_on_the_card_equal_the_cpus(cuda):
    """utils/flops.py counts the same work on the card as on the CPU where
    another implementation runs: torch._int_mm on padded operands (the
    CPU: one float64 matmul) and the dsconv kernel (the CPU: its plain
    version's taps and matmul)."""
    from deepdish_tpu_torch.models.qgraph import int8_matmul, int8_weight
    from deepdish_tpu_torch.ops.dsconv import fused_dsconv
    from deepdish_tpu_torch.utils import flops
    rng = np.random.RandomState(4)
    a = rng.randint(-128, 128, (17, 27)).astype(np.int8)
    w = rng.randint(-127, 128, (27, 45)).astype(np.int8)
    x = torch.from_numpy(rng.standard_normal((2, 11, 13, 8)).astype(
        np.float32))
    weights = (torch.randn(3, 3, 8), torch.ones(8), torch.zeros(8),
               torch.randn(8, 16), torch.ones(16), torch.zeros(16))
    totals = {}
    for dev in (cuda, torch.device("cpu")):
        with torch.inference_mode(), flops.Count() as c:
            int8_matmul(torch.from_numpy(a).to(dev), int8_weight(w, dev), 45)
            for stride in (1, 2):
                fused_dsconv(x.to(dev), *(t.to(dev) for t in weights),
                             stride=stride)
        totals[dev.type] = c.total
    assert totals["cuda"] == totals["cpu"] > 2 * 17 * 27 * 45


def test_quantized_executor_card_matches_cpu(cuda, tmp_path):
    """chip_smoke.py's per-op full-integer graphs through the integer
    executor on the card (each conv_impl form) and on the CPU: every
    tensor equal (SOFTMAX's probabilities within 5e-7)."""
    import chip_smoke
    x = torch.from_numpy(np.random.RandomState(4).randint(
        -128, 128, (4, 8, 8, 16)).astype(np.int8))
    for op, g in chip_smoke.quantized_op_graphs().items():
        path = str(tmp_path / f"{op}.tflite")
        with open(path, "wb") as f:
            f.write(g.tflite())
        _, problems, _ = chip_smoke._env_card_vs_cpu(path, x, cuda)
        assert not problems, (op, problems)


def test_multistream_engine_on_the_card(cuda):
    """MultiStreamEngine.step_chunk, 4 streams over two shards of the one
    card, each stream equal to its own FrameStep.run_chunk (integers
    exact), the states on the card, and the LSAP kernel launched."""
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models import (COCO_LABELS, create_box_encoder,
                                           create_detector)
    from deepdish_tpu_torch.parallel import MultiStreamEngine, make_mesh
    from deepdish_tpu_torch.pipeline import FrameStep
    det = create_detector("ssd_mobilenet", device=cuda,
                          compute_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    enc = create_box_encoder("mars", device=cuda, compute_dtype=torch.float32,
                             generator=torch.Generator().manual_seed(1))
    cfg = tt.TrackerConfig(max_tracks=16, max_detections=8,
                           gallery_size=32, num_labels=len(COCO_LABELS))
    fs = FrameStep(det, enc, cfg, COCO_LABELS, (96, 128), device=cuda)
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (96, 128, 3))
    frames = np.clip(base[None] + rng.randint(-4, 5, (4, 96, 128, 3)), 0,
                     255).astype(np.uint8)
    streams = np.stack([frames, frames[:, :, ::-1], np.roll(frames, 72, 2),
                        frames[:, ::-1, ::-1]])
    eng = MultiStreamEngine(fs, 4, make_mesh(2, device=cuda))
    before = lsap.launches
    states, outs, snaps = eng.step_chunk(eng.init_states(), streams)
    torch.cuda.synchronize()
    assert lsap.launches > before
    for s in range(4):
        assert states.stream(s).table.mean.device.type == "cuda"
        _, o, sn = fs.run_chunk(fs.init_state(), streams[s])
        for name in ("track_id", "state", "matched_det"):
            np.testing.assert_array_equal(getattr(outs, name)[s].cpu().numpy(),
                                          getattr(o, name).cpu().numpy())
        np.testing.assert_array_equal(snaps.valid[s].cpu().numpy(),
                                      sn.valid.cpu().numpy())


class _CodedWalkers:
    """A scripted detector on `device` for `_walker_scene`: each frame
    carries its stream s and frame t in a top-left block (10 s, 10 t), read
    back on the device, and the boxes are the scene's for (s, t)."""

    labels = {0: "person"}
    height, width = 16, 16
    compute_dtype = torch.float32

    def __init__(self, boxes, valid, device):
        self.device = device
        self.boxes = torch.as_tensor(boxes, dtype=torch.float32,
                                     device=device)
        self.valid = torch.as_tensor(valid, device=device)

    def detect(self, images, orig_w, orig_h):
        code = (images[:, 2, 2, :2] / 10).round().long()
        xyxy = self.boxes[code[:, 0], code[:, 1]]
        valid = self.valid[code[:, 0], code[:, 1]]
        return (xyxy, torch.zeros(valid.shape, dtype=torch.int32,
                                  device=self.device),
                valid.to(torch.float32) * 0.9, valid)


def _walker_scene(n_streams, n_frames, seed=5, h=96, w=128, walkers=4):
    """(frames (S, F, h, w, 3) uint8, boxes (S, F, walkers, 4) xyxy, valid
    (S, F, walkers)): textured 10 x 14 walkers at constant velocity, each
    missed in 15% of the frames, stream s seeded apart."""
    rng = np.random.RandomState(seed)
    frames = np.full((n_streams, n_frames, h, w, 3), 40, np.uint8)
    boxes = np.zeros((n_streams, n_frames, walkers, 4), np.float32)
    valid = rng.uniform(size=(n_streams, n_frames, walkers)) > 0.15
    for s in range(n_streams):
        # in the frame and below the code block for all n_frames <= 20
        start = np.c_[rng.uniform(44, w - 54, walkers),
                      rng.uniform(40, h - 36, walkers)]
        vel = np.c_[rng.randint(-2, 3, walkers), rng.randint(-1, 2, walkers)]
        tex = rng.randint(60, 256, (walkers, 14, 10, 3)).astype(np.uint8)
        for t in range(n_frames):
            frames[s, t, :16, :16] = (10 * s, 10 * t, 0)
            for k in range(walkers):
                x, y = (start[k] + t * vel[k]).astype(int)
                frames[s, t, y:y + 14, x:x + 10] = tex[k]
                boxes[s, t, k] = (x, y, x + 10, y + 14)
    return frames, boxes, valid


def test_batched_tracker_engine_equals_streams_alone(cuda, monkeypatch):
    """The 16-stream MultiStreamEngine, one batched tracker step a call,
    gives over 20 calls of the walker scene the integer outputs of each
    stream stepped alone; the LSAP kernel launches once a batched cascade
    level or IoU stage (B = 16), not once a stream."""
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.kernels import lsap
    from deepdish_tpu_torch.models.encoders import make_dummy_encoder
    from deepdish_tpu_torch.parallel import MultiStreamEngine, make_mesh
    from deepdish_tpu_torch.pipeline import FrameStep
    from deepdish_tpu_torch.tracker import matching
    S, F = 16, 20
    frames, boxes, valid = _walker_scene(S, F)
    cfg = tt.TrackerConfig(max_tracks=16, max_detections=boxes.shape[2],
                           gallery_size=32, num_labels=1, max_age=5)
    fs = FrameStep(_CodedWalkers(boxes, valid, cuda),
                   make_dummy_encoder(cuda), cfg, ["person"],
                   frames.shape[2:4], device=cuda)
    solved = []
    plain = matching.masked_min_cost_matching
    monkeypatch.setattr(matching, "masked_min_cost_matching",
                        lambda *a: (solved.append(a[0].shape[0]),
                                    plain(*a))[1])
    eng = MultiStreamEngine(fs, S, make_mesh(1, device=cuda))
    states, outs = eng.init_states(), []
    before = lsap.launches
    for t in range(F):
        states, out, _snaps = eng.step(states, frames[:, t])
        outs.append(out)
    torch.cuda.synchronize()
    batched = lsap.launches - before
    assert batched == len(solved) > 0 and set(solved) == {S}
    before = lsap.launches
    confirmed = 0
    for s in range(S):
        st = fs.init_state()
        for t in range(F):
            st, o, _snap, _raw = fs.step(st, frames[s, t])
            for name in ("track_id", "state", "matched_det", "deleted_id",
                         "hits", "age", "time_since_update",
                         "label_count"):
                np.testing.assert_array_equal(
                    getattr(outs[t], name)[s].cpu().numpy(),
                    getattr(o, name).cpu().numpy(),
                    err_msg=f"stream {s} frame {t} {name}")
            confirmed += int((o.state == tt.CONFIRMED).sum())
    torch.cuda.synchronize()
    assert confirmed > 0
    assert lsap.launches - before > 4 * batched


def test_probe_int8_legs_card_equal_cpu(cuda):
    """tools/probe_int8.py's int8 steps (int8_matmul / im2col + int8_matmul,
    `>> 7` to int8) on the card equal the CPU's exactly, chained twice, on
    seeded inputs: the square product (rows past 16 and not a multiple of
    8 padded) and the JAX tool's three conv shapes on two images."""
    from deepdish_tpu_torch.tools import probe_int8 as p
    cpu = torch.device("cpu")
    rng = np.random.RandomState(9)
    n = 1024
    kb, ki = p.matmul_weights(n)
    x8 = torch.from_numpy(rng.randint(-127, 128, (37, n)).astype(np.int8))
    steps = [p.matmul_steps(kb, ki, d)[1] for d in (cuda, cpu)]
    got = steps[0](steps[0](x8.to(cuda))).cpu()
    assert torch.equal(got, steps[1](steps[1](x8)))
    for _, _, hw, cin, cout, k in p.CONVS:
        kb, ki = p.conv_weights(cin, cout, k)
        x8 = torch.from_numpy(rng.randint(-127, 128, (2, hw, hw, cin))
                              .astype(np.int8))
        steps = [p.conv_steps(kb, ki, d)[1] for d in (cuda, cpu)]
        got = steps[0](steps[0](x8.to(cuda))).cpu()
        assert torch.equal(got, steps[1](steps[1](x8)))


def test_mars_q_dot_equals_conv_on_the_card(cuda):
    """The w8a8 MARS's two int8 contractions on the card: impl "dot"
    (im2col + torch._int_mm) and "conv" (float64 direct convolution, cuDNN
    off) give equal int32 accumulators, equal to the CPU's on the card's
    int8 inputs, and bit-equal bf16 features."""
    from deepdish_tpu_torch.models import mars_q
    from deepdish_tpu_torch.models.layers import flax_default_init_
    from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
    net = MarsNet()
    flax_default_init_(net, torch.Generator().manual_seed(0))
    q = mars_q.quantize_mars(net.state_dict(),
                             mars_q.default_calibration_patches(16))
    qp = {d.type: mars_q.prepare_qparams(q, d)
          for d in (cuda, torch.device("cpu"))}
    x = torch.from_numpy(np.random.RandomState(10).uniform(
        0, 255, (4,) + INPUT_SHAPE).astype(np.float32)).to(cuda)
    accs, feats = {}, {}
    for impl in ("dot", "conv"):
        accs[impl] = {}
        feats[impl] = mars_q.mars_forward(
            qp["cuda"]["base"], x, compute_dtype=torch.bfloat16,
            qparams=qp["cuda"], impl=impl, acc_sink=accs[impl])
    assert torch.equal(feats["dot"], feats["conv"])
    for path, (v8, acc) in accs["dot"].items():
        assert torch.equal(acc, accs["conv"][path][1]), path
        k8 = q["wq"][path]
        if v8.dim() == 4:
            stride = 2 if acc.shape[1] < v8.shape[1] else 1
            want = mars_q.conv_i8(v8.cpu(), qp["cpu"]["wmat"][path],
                                  k8.shape[0], k8.shape[1], stride,
                                  k8.shape[3])
        else:
            from deepdish_tpu_torch.models.qgraph import int8_matmul
            want = int8_matmul(v8.cpu(), qp["cpu"]["wmat"][path], k8.shape[1])
        assert torch.equal(acc.cpu(), want), path
