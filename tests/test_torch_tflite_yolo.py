"""Port parity of the structural weight path for YOLOv5s (a .tflite) and
YOLOv3 (a Keras .h5), at full width, against the JAX package on the CPU
(tests/test_torch_tflite_ssd.py's helpers and checks):

  * YOLOv5s: tests/test_yolov5_real_tflite.py `_make_yolov5_tflite` read
    alike by both packages, the slot lists equal (the C3 blocks' parallel
    cv1 / cv2 bind by signature), the conversion equal to the JAX one, and
    the detector each registry builds from the file (input 320) equal on
    two images (`detector_matches`: raw outputs within 1e-4 of their
    range, `detect` on the same raw outputs to
    tests/test_torch_families.py's tolerances);
  * YOLOv3: a Keras HDF5 in keras-yolo3's layout (conv2d_<k> and
    batch_normalization_<k> layers in network order, what
    `read_keras_h5` reads from the reference's yolo.h5) written with h5py
    from a seeded donor; the slot lists, `convert_keras_h5` and the
    registry's detectors (input 416) equal as above;
  * the small Keras model of tests/test_convert.py's h5 round trip, against
    the JAX conversion and Keras's own forward pass;
  * the fold round trip of both families, with no tensorflow;
  * the registry's fail-loudly contract on files that do not convert."""
import functools

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import numpy as np
import torch

import deepdish_tpu.models.registry as j_registry
from deepdish_tpu.models import convert as jcv
from deepdish_tpu.models import yolov3 as jy3
from deepdish_tpu.models import yolov5 as jy5
from deepdish_tpu.models.weights import _flatten
from deepdish_tpu_torch.models import convert as pcv
from deepdish_tpu_torch.models import create_detector
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models import yolov3 as py3
from deepdish_tpu_torch.models import yolov5 as py5
from deepdish_tpu_torch.models.layers import BatchNorm, SameConv2d
from test_torch_models import numpy_flax_variables
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tflite_ssd import (bind_jax_trace, detector_matches,
                                   fold_roundtrip, image, jax_conversion,
                                   jax_trace, same_flat, same_readers,
                                   same_report, same_slots)

pytestmark = pytest.mark.timeout(300)
F32 = jnp.float32


@pytest.fixture(scope="module")
def jax_registry():
    """The JAX registry with float32 YOLO detectors and the cached
    trace."""
    with pytest.MonkeyPatch.context() as mp:
        bind_jax_trace(mp)
        for cls in (jy5.YOLOv5Detector, jy3.YOLOv3Detector):
            mp.setattr(j_registry, cls.__name__,
                       functools.partial(cls, compute_dtype=F32))
        yield


def _slots(pnet_cls, shape):
    with torch.device("meta"):
        return pcv.trace_slots(pnet_cls(), shape)[1]


_FAMILY = {"yolov5": (jy5.YOLOv5s, py5.YOLOv5s, 320),
           "yolov3": (jy3.YOLOv3, py3.YOLOv3, 416)}


@pytest.mark.parametrize("family", list(_FAMILY))
def test_slots_match_jax(family):
    jnet, pnet, size = _FAMILY[family]
    same_slots(_slots(pnet, (1, size, size, 3)),
               jax_trace(jnet(), (size, size, 3))[1])


# ---------------------------------------------------------------- YOLOv5s

@pytest.fixture(scope="module")
def yolov5_tflite(tmp_path_factory):
    pytest.importorskip("tensorflow")
    from test_yolov5_real_tflite import _make_yolov5_tflite
    return _make_yolov5_tflite(tmp_path_factory.mktemp("yolov5"))


def test_yolov5_readers_match_jax(yolov5_tflite):
    assert same_readers(yolov5_tflite) is None
    ops, _ = pcv.read_tflite(yolov5_tflite)
    assert sum(o.kind == "conv" for o in ops) == 60


def test_yolov5_conversion_and_detector_match_jax(yolov5_tflite,
                                                  jax_registry):
    jvars, jslots = jax_trace(jy5.YOLOv5s(), (320, 320, 3))
    got, rep = pcv.load_yolov5_tflite(yolov5_tflite)
    want, wrep = jax_conversion(jslots, jvars, yolov5_tflite)
    same_report(rep, wrep)
    assert rep["assigned"] == rep["total"] == 60
    assert not rep["missing"] and not rep["unused_ops"]
    same_flat(got, want)
    jdet = j_registry.create_detector(yolov5_tflite)
    pdet = create_detector(yolov5_tflite, device="cpu",
                           compute_dtype=torch.float32)
    same_flat(pw.to_flax(pdet.net), want)
    assert max(detector_matches(jdet, pdet, 320)) > 0


def test_yolov5_fold_roundtrip_matches_jax():
    fold_roundtrip(jy5.YOLOv5s(), (320, 320, 3), py5.YOLOv5s,
                   (1, 320, 320, 3), pw.yolov5_from_flax, seed=31,
                   x=image(32, 320)[None])


# ---------------------------------------------------------------- YOLOv3

def write_keras_h5(path, flat, slots):
    """`flat`'s convs and batch norms as a Keras HDF5 weights file in
    keras-yolo3's layout: per conv slot a conv2d_<k> layer (kernel HWIO,
    bias when it has one) and a batch_normalization_<k> layer (gamma,
    beta, moving_mean, moving_variance) after it, in slot order, with the
    weightless layers (input, leaky_re_lu_<k>) between them."""
    import h5py
    layers, nbn = [("input_1", {})], 0
    for k, s in enumerate(slots, start=1):
        p = "/".join(s.path)
        conv = {"kernel": flat[f"params/{p}/kernel"]}
        if s.has_bias:
            conv["bias"] = flat[f"params/{p}/bias"]
        layers.append((f"conv2d_{k}", conv))
        if s.bn_path is not None:
            nbn += 1
            bn = "/".join(s.bn_path)
            layers.append((f"batch_normalization_{nbn}", {
                "gamma": flat[f"params/{bn}/scale"],
                "beta": flat[f"params/{bn}/bias"],
                "moving_mean": flat[f"batch_stats/{bn}/mean"],
                "moving_variance": flat[f"batch_stats/{bn}/var"]}))
            layers.append((f"leaky_re_lu_{nbn}", {}))
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = [n.encode() for n, _ in layers]
        for name, wts in layers:
            lg = g.create_group(name)
            lg.attrs["weight_names"] = [f"{name}/{w}:0".encode()
                                        for w in wts]
            for w, arr in wts.items():
                lg.create_dataset(f"{name}/{w}:0", data=arr)
    return path


@pytest.fixture(scope="module")
def yolov3_h5(tmp_path_factory):
    pytest.importorskip("h5py")
    jvars, jslots = jax_trace(jy3.YOLOv3(), (416, 416, 3))
    donor = _flatten(numpy_flax_variables(
        jy3.YOLOv3(compute_dtype=F32), jnp.zeros((416, 416, 3), F32),
        seed=41))
    path = str(tmp_path_factory.mktemp("yolov3") / "yolo.h5")
    return write_keras_h5(path, donor, jslots), donor


def test_yolov3_h5_conversion_and_detector_match_jax(yolov3_h5,
                                                     jax_registry):
    path, donor = yolov3_h5
    got, rep = pcv.load_yolov3_h5(path)
    want, wrep = jcv.load_yolov3_h5(path)
    assert rep == wrep
    assert rep["assigned"] == rep["total"] == 75 and not rep["missing_bn"]
    same_flat(got, _flatten(want))
    same_flat(got, donor)
    jdet = j_registry.create_detector(path)
    pdet = create_detector(path, device="cpu", compute_dtype=torch.float32)
    same_flat(pw.to_flax(pdet.net), donor)
    assert max(detector_matches(jdet, pdet, 416)) > 0


def test_yolov3_fold_roundtrip_matches_jax():
    fold_roundtrip(jy3.YOLOv3(), (416, 416, 3), py3.YOLOv3,
                   (1, 416, 416, 3), pw.yolov3_from_flax, seed=42,
                   x=image(43, 416)[None])


# ---------------------------------------------------------------- small h5

class SmallKerasNet(torch.nn.Module):
    """The port twin of tests/test_convert.py's h5 round-trip net (flax
    auto-names Conv_0, BatchNorm_0, Conv_1, BatchNorm_1, Conv_2)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = SameConv2d(3, 8, 3)
        self.BatchNorm_0 = BatchNorm(8)
        self.Conv_1 = SameConv2d(8, 12, 3)
        self.BatchNorm_1 = BatchNorm(12)
        self.Conv_2 = SameConv2d(12, 4, 1, bias=True)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = torch.nn.functional.leaky_relu(self.BatchNorm_0(self.Conv_0(x)),
                                           0.1)
        x = torch.nn.functional.leaky_relu(self.BatchNorm_1(self.Conv_1(x)),
                                           0.1)
        return self.Conv_2(x).permute(0, 2, 3, 1)


def test_small_keras_h5_matches_jax(tmp_path):
    tf = pytest.importorskip("tensorflow")
    import flax.linen as nn
    keras = tf.keras
    inp = keras.Input((16, 16, 3))
    x = keras.layers.Conv2D(8, 3, padding="same", use_bias=False)(inp)
    x = keras.layers.BatchNormalization(epsilon=1e-3)(x)
    x = keras.layers.LeakyReLU(negative_slope=0.1)(x)
    x = keras.layers.Conv2D(12, 3, padding="same", use_bias=False)(x)
    x = keras.layers.BatchNormalization(epsilon=1e-3)(x)
    x = keras.layers.LeakyReLU(negative_slope=0.1)(x)
    x = keras.layers.Conv2D(4, 1, use_bias=True)(x)
    model = keras.Model(inp, x)
    r = np.random.RandomState(1)
    for layer in model.layers:
        if isinstance(layer, keras.layers.BatchNormalization):
            ws = layer.get_weights()
            ws[2] = r.normal(0, 0.3, ws[2].shape).astype(np.float32)
            ws[3] = r.uniform(0.5, 2.0, ws[3].shape).astype(np.float32)
            layer.set_weights(ws)
    path = str(tmp_path / "m.h5")
    model.save(path)

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Conv(8, (3, 3), padding="SAME", use_bias=False)(x)
            x = nn.BatchNorm(use_running_average=True, epsilon=1e-3)(x)
            x = nn.leaky_relu(x, 0.1)
            x = nn.Conv(12, (3, 3), padding="SAME", use_bias=False)(x)
            x = nn.BatchNorm(use_running_average=True, epsilon=1e-3)(x)
            x = nn.leaky_relu(x, 0.1)
            return nn.Conv(4, (1, 1))(x)

    naming = pw.FlaxNaming(pw._renamer({}))
    want, wrep = jcv.convert_keras_h5(Net(), (1, 16, 16, 3), path)
    with torch.device("meta"):
        got, rep = pcv.convert_keras_h5(SmallKerasNet(), (1, 16, 16, 3),
                                        path, naming=naming)
    assert rep == wrep and rep["assigned"] == rep["total"] == 3
    same_flat(got, _flatten(want))
    net = SmallKerasNet()
    net.load_state_dict(pw._from_flax(got, {}))
    x = np.random.RandomState(2).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)
    with torch.inference_mode():
        out = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, model.predict(x, verbose=0), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("fname", ["yolov5s.tflite", "yolo.h5",
                                   "ssd_frozen.pb"])
def test_registry_fail_loudly_matches_jax(tmp_path, fname):
    """A weight file that does not convert raises the JAX package's
    message (naming the port's converter); test_torch_families'
    test_registry_dispatch holds --allow-random-weights."""
    path = tmp_path / fname
    path.write_bytes(b"not a weight file")
    msgs = []
    for create in (j_registry.create_detector,
                   functools.partial(create_detector, device="cpu")):
        with pytest.raises(ValueError) as e:
            create(str(path))
        msgs.append(str(e.value).split(":")[0])
    assert msgs[0] == msgs[1]
