"""Port parity of Faster R-CNN (deepdish_tpu_torch/models/faster_rcnn.py)
against the JAX package on the CPU, at the JAX tests' TINY configuration
(input 64, units (1, 2, 1, 1), 3 classes, pre_nms_topk 96, 16 proposals).

JAX variables of TINY's shapes filled from a numpy seed (float32) are
bridged into the port with `models.weights.faster_rcnn_from_flax`; both
packages get the same seeded numpy images, the port with device="cpu".
Kernels are drawn from a numpy seed and the batch norms calibrated on
seeded images (`calibrate_bn`), so activations stay O(1) through the
depth. Three weight sets: "spread" (as drawn: softmax scores spread),
"saturated" (class heads scaled x1e4: scores 1.0, so nearly every pick is a
tie) and "tie_heavy" (both class heads zeroed: objectness 0.5 and class
probabilities 0.25 everywhere). For each, in both second-stage
modes:

  * fmap, rpn_box, rpn_cls, probs2 and box2 within |a - b| <= 1e-5 *
    max|b| (float32 convolutions summed in another order);
  * prop_valid, classes and valid exactly; proposals, prop_ychw and boxes
    within 1e-4 * max|b| (the box decode's exp amplifies the heads'
    differences); scores within 1e-5;
  * a batch of frames equals the frames one at a time.

Also the pieces on ties (argsort_desc_tie_low, _greedy(tie_high=False),
crop_and_resize, anchors and decode), `detect` in pixels, and the port's
FrameStep `step` and `run_chunk` with the TINY detector against JAX's:
track ids, snapshot boxes (integers) and labels exactly.

With tensorflow installed: a TF1 SavedModel directory with TF-OD
faster_rcnn names through both packages' `create_detector` (plus a .pbtxt
label map) gives the same detector and detections (at input 64: the
packages' loaders bound to it), and both CLIs on it the same counters and
MQTT payloads."""
import asyncio
import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import numpy as np
import torch

from deepdish_tpu.models import faster_rcnn as jf
from deepdish_tpu.models.weights import _flatten
from deepdish_tpu.ops import nms as jnms
from deepdish_tpu.ops import onehot as joh
from deepdish_tpu_torch.models import faster_rcnn as pf
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.ops import nms as pnms
from deepdish_tpu_torch.ops import onehot as poh
from test_torch_models import numpy_flax_variables

_UNPATCHED_CROP = jf.crop_and_resize

pytestmark = pytest.mark.timeout(300)

F32 = jnp.float32
TINY = jf.FasterRCNNConfig(input_size=64, stem_features=8,
                           block_units=(1, 2, 1, 1),
                           block_features=(16, 32, 64, 128),
                           num_classes=3, rpn_features=16,
                           pre_nms_topk=96, max_proposals=16, crop_size=14)
MODES = ("argmax", "per_class")
KINDS = ("spread", "saturated", "tie_heavy")
THRESHOLD = 0.05
N_OUT = 8


def port_config(cfg):
    return pf.FasterRCNNConfig(**dataclasses.asdict(cfg))


def calibrate_bn(net, images):
    """Set every batch norm's statistics to those of its input on
    `images` (B, S, S, 3), so each normalises to mean 0 and variance 1
    there: through random weights the activations then neither vanish nor
    explode, and float32 summation order stays at the 1e-6 level."""
    from deepdish_tpu_torch.models.layers import BatchNorm

    def set_stats(bn, args):
        bn.running_mean.copy_(args[0].mean((0, 2, 3)))
        bn.running_var.copy_(args[0].var((0, 2, 3), unbiased=False))
    hooks = [m.register_forward_pre_hook(set_stats)
             for m in net.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            net(torch.from_numpy(images))
    finally:
        for h in hooks:
            h.remove()


def tiny_variables(kind, seed=0):
    """TINY's flax variables: kernels from a numpy seed, batch norms
    calibrated on seeded images (through the port and back with
    `faster_rcnn_to_flax`), the class heads kept (spread), scaled up until
    every score is 1.0 (saturated) or zeroed (tie_heavy)."""
    net = pf.FasterRCNNNet(port_config(TINY))
    net.load_state_dict(pw.faster_rcnn_from_flax(_flatten(
        numpy_flax_variables(jf.FasterRCNNNet(cfg=TINY, compute_dtype=F32),
                             jnp.zeros((64, 64, 3), F32), seed=seed))))
    calibrate_bn(net, _images(100 + seed, n=4))
    flat = pw.faster_rcnn_to_flax(net)
    scale = {"spread": 1.0, "saturated": 1e4, "tie_heavy": 0.0}[kind]
    for head in ("rpn_cls", "cls_head"):
        for leaf in ("kernel", "bias"):
            flat[f"params/{head}/{leaf}"] *= scale
    return pw._unflatten(flat)


def jax_crop_edge_exact(fmap, boxes_yxyx, crop_h, crop_w):
    """The JAX package's crop_and_resize (faster_rcnn.py:135) with the
    port's one deviation: each axis's last sample exactly on the box's far
    edge (hi * (extent - 1)), so that no proposal clipped to the image
    edge loses its last crop row to rounding. Bound into the JAX package
    for the parity tests (`edge_exact_jax`)."""
    Hf, Wf = fmap.shape[0], fmap.shape[1]

    def weights(lo, hi, n, extent):
        steps = jnp.arange(n, dtype=jnp.float32)
        pos = (lo[:, None] * (extent - 1)
               + steps[None, :] * ((hi - lo) * (extent - 1))[:, None]
               / (n - 1))
        pos = pos.at[:, -1].set(hi * (extent - 1))
        grid = jnp.arange(extent, dtype=jnp.float32)
        w = jnp.maximum(0.0, 1.0 - jnp.abs(pos[..., None] - grid))
        in_range = (pos >= 0.0) & (pos <= extent - 1)
        return (w * in_range[..., None]).astype(fmap.dtype)

    wy = weights(boxes_yxyx[:, 0], boxes_yxyx[:, 2], crop_h, Hf)
    wx = weights(boxes_yxyx[:, 1], boxes_yxyx[:, 3], crop_w, Wf)
    rows = jnp.einsum("pih,hwc->piwc", wy, fmap)
    return jnp.einsum("piwc,pjw->pijc", rows, wx)


_TRACES = {}


def _cached_trace_slots(trace_slots):
    """The JAX package's `trace_slots` with the net's init jitted (one
    compile instead of the op-by-op compiles of an eager init: 8 s against
    30-45 s for these nets) and its result kept per (net, shape, key). The
    name-map converters copy the variables before they fill them."""
    def trace(net, example_shape, rngs=None):
        key = (repr(net), tuple(example_shape),
               None if rngs is None else tuple(np.asarray(rngs).tolist()))
        if key not in _TRACES:
            object.__setattr__(net, "init", jax.jit(net.init))
            _TRACES[key] = trace_slots(net, example_shape, rngs)
        return _TRACES[key]
    return trace


def fast_jax_conversion(mp):
    """Speed bindings of the JAX package's converter: `trace_slots` as
    `_cached_trace_slots`, and its signature pass (`_annotate_slot_sigs`,
    20-50 s a net, read only by the TFLite binding) a no-op; the name-map
    converters read neither the signatures nor the init's values where
    they fill every leaf."""
    from deepdish_tpu.models import convert as jcv
    mp.setattr(jcv, "_annotate_slot_sigs", lambda *a, **k: None)
    mp.setattr(jcv, "trace_slots", _cached_trace_slots(jcv.trace_slots))


@pytest.fixture(scope="module", autouse=True)
def edge_exact_jax():
    """The JAX package's Faster R-CNN with `jax_crop_edge_exact` for this
    module's tests (test_crop_and_resize_matches_jax holds the port
    against the unchanged JAX function), and `fast_jax_conversion`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf, "crop_and_resize", jax_crop_edge_exact)
        fast_jax_conversion(mp)
        yield


def _mode_cfg(mode):
    return dataclasses.replace(TINY, second_stage_mode=mode,
                               max_detections_per_class=4)


@pytest.fixture(scope="module")
def nets():
    """(kind, mode) -> (JAX apply with intermediates, port net), built on
    first use; the JAX apply is jitted once per mode."""
    applies = {m: jax.jit(functools.partial(
        jf.FasterRCNNNet(cfg=_mode_cfg(m), max_outputs=N_OUT,
                         score_threshold=THRESHOLD, compute_dtype=F32).apply,
        with_intermediates=True)) for m in MODES}
    variables = {k: tiny_variables(k) for k in KINDS}

    class Nets(dict):
        def __missing__(self, key):
            kind, mode = key
            net = pf.FasterRCNNNet(port_config(_mode_cfg(mode)),
                                   max_outputs=N_OUT,
                                   score_threshold=THRESHOLD)
            net.load_state_dict(pw.faster_rcnn_from_flax(
                _flatten(variables[kind])))
            net.eval().requires_grad_(False)
            self[key] = (functools.partial(applies[mode], variables[kind]),
                         net)
            return self[key]
    return Nets()


def _images(seed, n=2, size=64):
    return np.random.RandomState(seed).uniform(
        0, 255, (n, size, size, 3)).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0) <= \
        rel * max(np.abs(want).max(initial=0), 1.0), \
        (np.abs(got - want).max(), np.abs(want).max())


def _check_first_stage(inter, want):
    """fmap and the RPN heads within 1e-5, proposals within 1e-4 (the
    decode's exp), prop_valid exactly."""
    for key, rel in (("fmap", 1e-5), ("rpn_box", 1e-5), ("rpn_cls", 1e-5),
                     ("proposals", 1e-4)):
        _close(inter[key], want[key], rel)
    np.testing.assert_array_equal(inter["prop_valid"],
                                  np.asarray(want["prop_valid"]))


def _check_outputs(got, want, rel_boxes=1e-4):
    boxes, classes, scores, valid = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[1], classes)
    _close(got[2], scores, 1e-5)
    _close(got[0], boxes, rel_boxes)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_network_matches_jax(nets, kind, mode):
    """Two frames in one batch. The first stage from the images; the
    second stage from JAX's own fmap, proposals and prop_valid (a proposal
    clipped to the image edge samples exactly on the map's last row, where
    one ulp of its other edge decides between that row and zeros, in both
    packages alike), so its integers are compared exactly."""
    japply, net = nets[kind, mode]
    imgs = _images(1 + KINDS.index(kind))
    want = [japply(jnp.asarray(img)) for img in imgs]
    wi = {k: np.stack([np.asarray(w[1][k]) for w in want])
          for k in want[0][1]}
    with torch.inference_mode():
        inter = {"fmap": net.trunk(torch.from_numpy(imgs))}
        net.proposals(inter["fmap"], inter)
        inter2 = {}
        out = net.second_stage(torch.from_numpy(wi["fmap"]),
                               torch.from_numpy(wi["proposals"]),
                               torch.from_numpy(wi["prop_valid"]), inter2)
    for i in range(len(imgs)):
        _check_first_stage({k: v[i].numpy() for k, v in inter.items()},
                           want[i][1])
        for key in ("probs2", "box2", "prop_ychw"):
            _close(inter2[key][i].numpy(), want[i][1][key], 1e-5)
        _check_outputs([o[i].numpy() for o in out], want[i][0],
                       rel_boxes=1e-5)
    assert out[3].sum(-1).min() > 0, out[3]
    if kind == "tie_heavy":
        # every objectness and class probability ties
        assert (inter["rpn_cls"] == 0).all()
        assert torch.allclose(inter2["probs2"], torch.tensor(0.25))
    if kind == "saturated":
        assert (inter2["probs2"].amax(-1) == 1).float().mean() > 0.9


@pytest.mark.parametrize("mode", MODES)
def test_batch_matches_single_frames(nets, mode):
    _, net = nets["spread", mode]
    imgs = torch.from_numpy(_images(7, n=3))
    with torch.inference_mode():
        batch, binter = net(imgs, with_intermediates=True)
        for i in range(3):
            one, ointer = net(imgs[i:i + 1], with_intermediates=True)
            _check_first_stage({k: v[0].numpy() for k, v in ointer.items()},
                               {k: v[i].numpy() for k, v in binter.items()})
            _check_outputs([o[0].numpy() for o in one],
                           [o[i].numpy() for o in batch])


def test_detect_matches_jax():
    v = tiny_variables("spread")
    jdet = jf.FasterRCNNDetector(params=v, config=TINY, max_outputs=N_OUT,
                                 score_threshold=THRESHOLD,
                                 compute_dtype=F32)
    pdet = pf.FasterRCNNDetector(
        state_dict=pw.faster_rcnn_from_flax(_flatten(v)),
        config=port_config(TINY), max_outputs=N_OUT,
        score_threshold=THRESHOLD, device="cpu")
    assert pdet.width == pdet.height == 64
    assert pdet.compute_dtype == torch.float32
    imgs = _images(3)
    with torch.inference_mode():
        got = pdet.detect(torch.from_numpy(imgs), 320.0, 240.0)
    for i, img in enumerate(imgs):
        want = jdet.detect_jit(jnp.asarray(img), jnp.float32(320),
                               jnp.float32(240))
        _check_outputs([g[i].numpy() for g in got], want)
        assert got[3][i].any()


# ---------------------------------------------------------------- pieces

def test_argsort_desc_tie_low_matches_jax():
    rng = np.random.RandomState(0)
    for n in (7, 300):
        scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)
        want = np.asarray(joh.argsort_desc_tie_low(jnp.asarray(scores)))
        got = poh.argsort_desc_tie_low(torch.from_numpy(scores))
        np.testing.assert_array_equal(got.numpy(), want)
    # batched: each row as its own call
    scores = np.round(rng.uniform(0, 1, (3, 40)), 1).astype(np.float32)
    got = poh.argsort_desc_tie_low(torch.from_numpy(scores)).numpy()
    for row, g in zip(scores, got):
        np.testing.assert_array_equal(
            g, np.asarray(joh.argsort_desc_tie_low(jnp.asarray(row))))


@pytest.mark.parametrize("tie_high", [False, True])
def test_greedy_ties_match_jax(tie_high):
    """The NMS pick order with quantised scores (many exact ties), plain
    IoU of yxyx boxes; both tie rules, one batched call against per-row
    JAX calls."""
    rng = np.random.RandomState(5)
    b, n = 3, 48
    base = rng.uniform(0, 60, (b, n, 2)).astype(np.float32)
    wh = rng.uniform(5, 25, (b, n, 2)).astype(np.float32)
    boxes = np.concatenate([base, base + wh], axis=-1)
    scores = np.round(rng.uniform(0.1, 1.0, (b, n)), 1).astype(np.float32)
    valid = rng.uniform(size=(b, n)) < 0.9
    order, keep = pnms._greedy(pf._iou_yxyx(torch.from_numpy(boxes)),
                               torch.from_numpy(scores),
                               torch.from_numpy(valid), 0.5,
                               tie_high=tie_high)
    for i in range(b):
        iou = jf._iou_yxyx(jnp.asarray(boxes[i]))
        np.testing.assert_allclose(
            pf._iou_yxyx(torch.from_numpy(boxes[i])).numpy(),
            np.asarray(iou), rtol=1e-6, atol=1e-7)
        jorder, jkeep = jnms._greedy(iou, jnp.asarray(scores[i]),
                                     jnp.asarray(valid[i]), 0.5,
                                     tie_high=tie_high)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(jorder))
    assert (keep.sum(-1) < torch.from_numpy(valid).sum(-1)).all()


def _edge_lo(n, extent):
    """A box edge lo in (0, 1) for which TF's float position of the last
    of n samples of a box ending at 1.0 rounds past extent - 1."""
    lo = np.linspace(0.01, 0.99, 4096).astype(np.float32)
    last = (lo * np.float32(extent - 1) + np.float32(n - 1)
            * ((np.float32(1) - lo) * np.float32(extent - 1))
            / np.float32(n - 1))
    return float(lo[np.argmax(last > extent - 1)])


def test_crop_and_resize_matches_jax():
    """Against the JAX package's own crop_and_resize (not the module's
    binding): boxes inside, a point, an inverted one and one partly
    outside (zero rows and columns). Then the one deviation: a box ending
    exactly on the map's far edge keeps its last row, which the float
    formula zeroes for this lo."""
    rng = np.random.RandomState(2)
    fmap = rng.normal(0, 1, (2, 9, 11, 5)).astype(np.float32)
    boxes = np.array([[0.0, 0.0, 1.0, 1.0],
                      [0.1, 0.2, 0.7, 0.9],
                      [0.5, 0.5, 0.5, 0.5],     # a point
                      [0.6, 0.4, 0.2, 0.8],     # y inverted
                      [-0.2, 0.9, 0.3, 1.4]],   # partly outside: zeros
                     np.float32)
    boxes = np.stack([boxes, boxes[::-1]])
    got = pf.crop_and_resize(torch.from_numpy(fmap), torch.from_numpy(boxes),
                             14, 6).numpy()
    for i in range(2):
        want = np.asarray(_UNPATCHED_CROP(jnp.asarray(fmap[i]),
                                          jnp.asarray(boxes[i]), 14, 6))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)
    assert (got[0, 4, :3] == 0).all() and (got[0, 4, :, -2:] == 0).all()

    lo = _edge_lo(14, 9)
    edge = np.array([[[lo, 0.0, 1.0, 1.0]]], np.float32)
    got = pf.crop_and_resize(torch.from_numpy(fmap[:1]),
                             torch.from_numpy(edge), 14, 6)[0, 0].numpy()
    want = np.asarray(_UNPATCHED_CROP(jnp.asarray(fmap[0]),
                                      jnp.asarray(edge[0]), 14, 6))[0]
    assert (want[-1] == 0).all()                 # the float formula's
    np.testing.assert_allclose(got[-1], fmap[0, -1, ::2], rtol=1e-5,
                               atol=1e-6)        # the map's last row
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jax_crop_edge_exact(jnp.asarray(fmap[0]),
                                            jnp.asarray(edge[0]), 14, 6))[0],
        rtol=1e-6, atol=1e-6)


def test_anchors_and_decode_match_jax():
    for cfg in (TINY, jf.FasterRCNNConfig()):
        np.testing.assert_array_equal(
            pf.generate_rpn_anchors(port_config(cfg)),
            jf.generate_rpn_anchors(cfg))
    rng = np.random.RandomState(4)
    enc = rng.normal(0, 2, (64, 4)).astype(np.float32)
    anchors = np.stack([rng.uniform(0, 64, 64), rng.uniform(0, 64, 64),
                        rng.uniform(4, 32, 64), rng.uniform(4, 32, 64)],
                       axis=1).astype(np.float32)
    np.testing.assert_allclose(
        pf.decode_rcnn_boxes(torch.from_numpy(enc),
                             torch.from_numpy(anchors)).numpy(),
        np.asarray(jf.decode_rcnn_boxes(jnp.asarray(enc),
                                        jnp.asarray(anchors))),
        rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------- frame step

def test_framestep_step_and_chunk_match_jax():
    """The TINY detector in both packages' FrameStep (dummy encoder,
    48x64 frames): `step` over 3 frames, then `run_chunk` over 3 more."""
    from deepdish_tpu import tracker as jt
    from deepdish_tpu.models import create_box_encoder as j_enc
    from deepdish_tpu.pipeline import FrameStep as JFrameStep
    from deepdish_tpu.pipeline import FrameStepConfig as JConfig
    from deepdish_tpu_torch import tracker as pt
    from deepdish_tpu_torch.models import create_box_encoder as p_enc
    from deepdish_tpu_torch.pipeline import FrameStep as PFrameStep
    from deepdish_tpu_torch.pipeline import FrameStepConfig as PConfig

    v = tiny_variables("spread")
    labels = {0: "person", 1: "car", 2: "dog"}
    jdet = jf.FasterRCNNDetector(params=v, config=TINY, max_outputs=8,
                                 score_threshold=0.3, compute_dtype=F32)
    pdet = pf.FasterRCNNDetector(
        state_dict=pw.faster_rcnn_from_flax(_flatten(v)),
        config=port_config(TINY), max_outputs=8, score_threshold=0.3,
        device="cpu")
    jdet.labels = pdet.labels = labels
    jdet.label_offset = pdet.label_offset = 0
    kw = dict(max_tracks=8, max_detections=8, gallery_size=16, num_labels=2,
              max_age=5)
    wanted = ["person", "car"]
    jfs = JFrameStep(jdet, j_enc("dummy"), jt.TrackerConfig(**kw), wanted,
                     (48, 64), JConfig(score_threshold=0.3))
    pfs = PFrameStep(pdet, p_enc("dummy", device="cpu"),
                     pt.TrackerConfig(**kw), wanted, (48, 64),
                     PConfig(score_threshold=0.3), device="cpu")
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (48, 64, 3))
    frames = np.clip(base + rng.randint(-6, 7, (6, 48, 64, 3)), 0,
                     255).astype(np.uint8)

    def same(jout, jsnap, pout, psnap):
        np.testing.assert_array_equal(psnap.valid.numpy(),
                                      np.asarray(jsnap.valid))
        np.testing.assert_array_equal(psnap.tlwh.numpy(),
                                      np.asarray(jsnap.tlwh))
        np.testing.assert_array_equal(psnap.label.numpy(),
                                      np.asarray(jsnap.label))
        np.testing.assert_array_equal(pout.track_id.numpy(),
                                      np.asarray(jout.track_id))
        np.testing.assert_allclose(pout.tlwh.numpy(), np.asarray(jout.tlwh),
                                   rtol=1e-4, atol=1e-3)

    js, ps = jfs.init_state(), pfs.init_state()
    for f in frames[:3]:
        js, jout, jsnap, _ = jfs.step(js, f)
        ps, pout, psnap, _ = pfs.step(ps, f)
        same(jout, jsnap, pout, psnap)
    js, jouts, jsnaps = jfs.run_chunk(js, frames[3:])
    ps, pouts, psnaps = pfs.run_chunk(ps, frames[3:])
    same(jouts, jsnaps, pouts, psnaps)
    assert int(psnaps.valid.sum()) > 0
    assert (pouts.track_id.numpy() > 0).any()


# ---------------------------------------------------------------- SavedModel

def tfod_named_tensors(flat, cfg):
    """Flat flax variables of a Faster R-CNN as TF-OD faster_rcnn
    graph-named tensors (the inverse of convert_faster_rcnn_tfod's map,
    tests/test_faster_rcnn.py:47), resnet_v1_<depth> from the unit count."""
    rv = f"resnet_v1_{3 * sum(cfg.block_units) + 2}"
    names = {}

    def put(tf_name, flax_name, bias=False):
        names[f"{tf_name}/weights"] = flat[f"params/{flax_name}/kernel"]
        if bias:
            names[f"{tf_name}/biases"] = flat[f"params/{flax_name}/bias"]
            return
        bn = f"{flax_name}_bn"
        for tfv, key in (("gamma", f"params/{bn}/scale"),
                         ("beta", f"params/{bn}/bias"),
                         ("moving_mean", f"batch_stats/{bn}/mean"),
                         ("moving_variance", f"batch_stats/{bn}/var")):
            names[f"{tf_name}/BatchNorm/{tfv}"] = flat[key]

    put(f"FirstStageFeatureExtractor/{rv}/conv1", "conv1")
    for b in range(1, 5):
        stage = ("FirstStageFeatureExtractor" if b <= 3
                 else "SecondStageFeatureExtractor")
        for u in range(1, cfg.block_units[b - 1] + 1):
            tf_u = f"{stage}/{rv}/block{b}/unit_{u}/bottleneck_v1"
            flax_u = f"block{b}/unit_{u}"
            for c in ("conv1", "conv2", "conv3"):
                put(f"{tf_u}/{c}", f"{flax_u}/{c}")
            if f"params/{flax_u}/shortcut/kernel" in flat:
                put(f"{tf_u}/shortcut", f"{flax_u}/shortcut")
    put("Conv", "rpn_conv", bias=True)
    put("FirstStageBoxPredictor/BoxEncodingPredictor", "rpn_box", bias=True)
    put("FirstStageBoxPredictor/ClassPredictor", "rpn_cls", bias=True)
    put("SecondStageBoxPredictor/BoxEncodingPredictor", "box_head",
        bias=True)
    put("SecondStageBoxPredictor/ClassPredictor", "cls_head", bias=True)
    return names


def write_tf1_saved_model(tf, tensors, out_dir):
    """A TF1 SavedModel whose variables carry `tensors`' names and values
    (as tests/test_faster_rcnn.py:177 builds one)."""
    tf1 = tf.compat.v1
    g = tf1.Graph()
    with g.as_default():
        for name, val in tensors.items():
            tf1.get_variable(name, initializer=np.asarray(val, np.float32))
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            b = tf1.saved_model.Builder(out_dir)
            b.add_meta_graph_and_variables(sess, ["serve"])
            b.save()
    return out_dir


PBTXT = ('item {\n  id: 1\n  name: "person"\n}\n'
         'item {\n  id: 2\n  name: "car"\n}\n'
         'item {\n  id: 3\n  name: "dog"\n}\n')


@pytest.fixture(scope="module")
def frcnn_saved_model(tmp_path_factory):
    """(SavedModel dir, label map, flat donor variables) of the spread TINY
    weights."""
    tf = pytest.importorskip("tensorflow")
    flat = _flatten(tiny_variables("spread"))
    d = tmp_path_factory.mktemp("frcnn")
    out = write_tf1_saved_model(tf, tfod_named_tensors(flat, TINY),
                                str(d / "frcnn_saved_model"))
    labelmap = d / "map.pbtxt"
    labelmap.write_text(PBTXT)
    return out, str(labelmap), flat


def small_frcnn(monkeypatch):
    """Both packages' Faster R-CNN from a SavedModel directory at input 64
    (their loaders default to the zoo's 640, which the JAX package
    compiles slowly on the CPU; the variables do not depend on it), the
    JAX package's in float32 (its default is bf16)."""
    from deepdish_tpu.models import convert as jcv
    from deepdish_tpu_torch.models import convert as pcv
    for mod in (jcv, pcv):
        monkeypatch.setattr(mod, "load_faster_rcnn_saved_model",
                            functools.partial(
                                mod.load_faster_rcnn_saved_model,
                                input_size=64))
    monkeypatch.setattr(jf, "FasterRCNNDetector", functools.partial(
        jf.FasterRCNNDetector, compute_dtype=F32))


def test_saved_model_dir_matches_jax(frcnn_saved_model, monkeypatch):
    """The port's create_detector on the directory: the checkpoint's
    architecture at the zoo input size 640, the .pbtxt labels and the
    donor's weights; then at input 64, the JAX package's detections."""
    from deepdish_tpu.models.registry import create_detector as j_create
    from deepdish_tpu_torch.models.registry import create_detector
    out_dir, labelmap, flat = frcnn_saved_model
    pdet = create_detector(out_dir, label_file=labelmap, device="cpu",
                           score_threshold=THRESHOLD)
    assert isinstance(pdet, pf.FasterRCNNDetector)
    assert pdet.cfg == pf.FasterRCNNConfig(
        input_size=640, stem_features=TINY.stem_features,
        block_units=TINY.block_units, block_features=TINY.block_features,
        num_classes=TINY.num_classes, rpn_features=TINY.rpn_features)
    assert pdet.width == pdet.height == 640      # the zoo input size
    assert pdet.labels == {0: "person", 1: "car", 2: "dog"}
    got = pdet.net.state_dict()
    want = pw.faster_rcnn_from_flax(flat)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())

    small_frcnn(monkeypatch)
    pdet = create_detector(out_dir, label_file=labelmap, device="cpu",
                           score_threshold=THRESHOLD)
    jdet = j_create(out_dir, label_file=labelmap, score_threshold=THRESHOLD)
    assert pdet.cfg == port_config(jdet.cfg)
    assert pdet.labels == jdet.labels
    img = _images(9, n=1)
    with torch.inference_mode():
        dets = [d[0].numpy() for d in pdet.detect(torch.from_numpy(img),
                                                  640.0, 480.0)]
    _check_outputs(dets, jdet.detect_jit(jnp.asarray(img[0]),
                                         jnp.float32(640),
                                         jnp.float32(480)))
    assert dets[3].any()


@pytest.mark.timeout(600)
def test_cli_saved_model_dir_matches_jax(tmp_path, monkeypatch,
                                         frcnn_saved_model):
    """Both CLIs on the TINY SavedModel directory (at input 64) with the
    .pbtxt map: identical counters and per-frame MQTT payloads."""
    from deepdish_tpu_torch.models import COCO_LABELS
    from test_torch_pipeline import (COMMON, RecordingMQTT, _compare,
                                     _last_counters, _texture_scene,
                                     _write_video, j_amain, j_runtime,
                                     p_amain, p_runtime)
    small_frcnn(monkeypatch)
    for mod in (j_runtime, p_runtime):
        monkeypatch.setattr(mod, "MQTTClient", RecordingMQTT)
    RecordingMQTT.runs = []
    out_dir, labelmap, _ = frcnn_saved_model
    video = tmp_path / "texture.mp4"
    _write_video(video, _texture_scene(n=6))
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video), "--model", out_dir,
                           "--labels", labelmap, "--encoder-model", "dummy",
                           "--wanted-labels", ",".join(COCO_LABELS[:3]
                                                       + ["dog"]),
                           "--score-threshold", "0.3",
                           "--chunk-size", "3", "--log", str(log)]
                          + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    n_tracks, n_dets = _compare(*pays)
    assert n_dets > 0
    assert _last_counters(logs[1]) == _last_counters(logs[0])
