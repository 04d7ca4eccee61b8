"""Port parity of the models: preprocess, MARS, SSD raw outputs, box decode
and postprocess. Both packages run in float32 on the CPU with the same
numpy-made weights (the flax variables are filled from a numpy seed and
bridged into the port with `ssd_from_flax` / `mars_from_flax`)."""
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX models are flax modules

import numpy as np
import jax.numpy as jnp
import torch

from deepdish_tpu.models import preprocess as jpre
from deepdish_tpu.models import ssd_mobilenet as jssd
from deepdish_tpu.models.encoders import make_mars_encoder as j_mars
from deepdish_tpu.models.mars import INPUT_SHAPE, MarsNet
from deepdish_tpu.models.weights import _flatten
from deepdish_tpu_torch.models import preprocess as ppre
from deepdish_tpu_torch.models import ssd_mobilenet as pssd
from deepdish_tpu_torch.models.encoders import make_mars_encoder as p_mars
from deepdish_tpu_torch.models.weights import mars_from_flax, ssd_from_flax

F32 = jnp.float32


def numpy_flax_variables(net, example, seed):
    """A flax variable tree of `net`'s shapes filled from a numpy seed:
    lecun-scaled kernels, small biases, and non-trivial batch-norm
    statistics, so the bridge's every mapping is exercised."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), example)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if "scale" in name or "var" in name:
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread while a module runs (the
    port's test files import this fixture): its convolutions at the tests'
    sizes gain little from more threads, and under the tier-1 run's six
    workers eight OpenMP threads each spin on oversubscribed cores (a
    1.5 s engine call took 90 s there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ssd():
    net = jssd.SSDMobileNetV1(compute_dtype=F32)
    variables = numpy_flax_variables(
        net, jnp.zeros((300, 300, 3), F32), seed=0)
    jdet = jssd.SSDMobileNetDetector(params=variables, compute_dtype=F32,
                                     score_threshold=0.3)
    pdet = pssd.SSDMobileNetDetector(
        state_dict=ssd_from_flax(_flatten(variables)), device="cpu",
        compute_dtype=torch.float32, score_threshold=0.3)
    return net, variables, jdet, pdet


def _image(seed, shape=(300, 300, 3)):
    return np.random.RandomState(seed).randint(0, 256, size=shape).astype(
        np.float32)


def test_resize_bilinear():
    img = np.random.RandomState(1).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    want = np.asarray(jpre.resize_bilinear_mxu(jnp.asarray(img), 300, 300,
                                               compute_dtype=F32))
    got = ppre.resize_bilinear_mxu(torch.from_numpy(img), 300, 300,
                                   compute_dtype=torch.float32)
    # 2-tap float32 sums of pixels <= 255: 1e-4 absolute
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    batched = ppre.resize_bilinear_mxu(torch.from_numpy(np.stack([img] * 2)),
                                       300, 300, compute_dtype=torch.float32)
    np.testing.assert_array_equal(batched[1].numpy(), got.numpy())


def test_crop_resize_patches():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    boxes = np.c_[rng.uniform(-20, 120, (10, 2)),
                  rng.uniform(0, 60, (10, 2))].astype(np.float32)
    boxes[3] = [200, 10, 30, 30]            # off the frame: not ok
    valid = np.ones(10, bool)
    valid[5] = False
    jp, jok = jpre.crop_resize_patches_mxu(
        jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid), 128, 64,
        compute_dtype=F32)
    pp, pok = ppre.crop_resize_patches_mxu(
        torch.from_numpy(img), torch.from_numpy(boxes),
        torch.from_numpy(valid), 128, 64, compute_dtype=torch.float32)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    assert not pok[3] and not pok[5] and pok.sum() >= 5
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-3)


def test_mars_features():
    net = MarsNet(compute_dtype=F32)
    variables = numpy_flax_variables(
        net, jnp.zeros((1,) + INPUT_SHAPE, F32), seed=3)
    jenc = j_mars(params=variables, compute_dtype=F32)
    penc = p_mars(state_dict=mars_from_flax(_flatten(variables)),
                  device="cpu", compute_dtype=torch.float32)
    patches = np.random.RandomState(4).uniform(
        0, 255, (3,) + INPUT_SHAPE).astype(np.float32)
    want = np.asarray(jenc.apply(jnp.asarray(patches)))
    got = penc.apply(torch.from_numpy(patches)).numpy()
    # unit vectors after ~20 float32 conv layers summed in another order
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_ssd_raw_outputs(ssd):
    net, variables, _, pdet = ssd
    img = _image(5)
    jbox, jcls = net.apply(variables, jnp.asarray(img))
    pbox, pcls = pdet.net(torch.from_numpy(img)[None])
    assert pbox.shape == (1,) + tuple(jbox.shape)
    assert pcls.shape == (1,) + tuple(jcls.shape)
    # 30 float32 conv layers in another summation order: relative 1e-4 of
    # the output's range
    for got, want in ((pbox[0], jbox), (pcls[0], jcls)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())


def test_decode_boxes():
    rng = np.random.RandomState(6)
    anchors = jssd.generate_anchors()
    np.testing.assert_array_equal(pssd.generate_anchors(), anchors)
    enc = rng.normal(size=(len(anchors), 4)).astype(np.float32)
    want = np.asarray(jssd.decode_boxes(jnp.asarray(enc),
                                        jnp.asarray(anchors)))
    got = pssd.decode_boxes(torch.from_numpy(enc),
                            torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_tie_heavy(seed):
    """Scores on a coarse grid tie a lot: top-k order, per-class NMS keep
    and compaction must match exactly."""
    rng = np.random.RandomState(10 + seed)
    n, c = 400, 6
    tl = rng.uniform(0, 0.8, (n, 2))
    boxes = np.c_[tl, tl + rng.uniform(0.02, 0.2, (n, 2))].astype(
        np.float32)
    probs = (rng.randint(0, 16, (n, c)) / 16.0).astype(np.float32)
    kw = dict(top_k=100, score_threshold=0.5, iou_threshold=0.5,
              max_outputs=32)
    want = jssd.postprocess_detections(
        jnp.asarray(boxes), jnp.asarray(probs), jnp.float32(640),
        jnp.float32(480), **kw)
    got = pssd.postprocess_detections(torch.from_numpy(boxes),
                                      torch.from_numpy(probs), 640.0, 480.0,
                                      **kw)
    for g, w in zip(got[1:], want[1:]):         # classes, scores, valid
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    assert got[3].sum() > 5


def test_detector_end_to_end(ssd):
    _, _, jdet, pdet = ssd
    img = _image(7)
    want = jdet.detect(jdet.params, jnp.asarray(img), jnp.float32(1280),
                       jnp.float32(720))
    got = [x[0] for x in pdet.detect(torch.from_numpy(img)[None], 1280.0,
                                     720.0)]
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[3].sum() > 0
    # scores are sigmoids of float32 logits (relative 1e-4, as above);
    # pixel boxes scale normalized coordinates by up to 1280
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-2)


def test_npz_weights_load(tmp_path):
    """A flat .npz of the JAX package's variables (what its
    models/weights.save_npz writes) loads through create_detector /
    create_box_encoder by path, to the same weights as the bridge."""
    from deepdish_tpu.models.weights import save_npz
    from deepdish_tpu_torch.models import create_box_encoder, create_detector
    mars_vars = numpy_flax_variables(MarsNet(compute_dtype=F32),
                                     jnp.zeros((1,) + INPUT_SHAPE, F32), 8)
    ssd_vars = numpy_flax_variables(jssd.SSDMobileNetV1(compute_dtype=F32),
                                    jnp.zeros((300, 300, 3), F32), 9)
    mars_path = str(tmp_path / "mars.npz")
    ssd_path = str(tmp_path / "ssd_mobilenet.npz")
    save_npz(mars_vars, mars_path)
    save_npz(ssd_vars, ssd_path)
    enc = create_box_encoder(mars_path, device="cpu")
    det = create_detector(ssd_path, device="cpu")
    for module, want in ((enc._apply_fn, mars_from_flax(_flatten(mars_vars))),
                         (det.net, ssd_from_flax(_flatten(ssd_vars)))):
        got = module.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          want[k].numpy())
    assert det.labels[0] == "person"
