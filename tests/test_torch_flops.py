"""FLOP counts of the port (deepdish_tpu_torch/utils/flops.py and
tools/flops_report.py) on the CPU:

  * the detector and encoder networks (SSD-MobileNetV1 and YOLOv5s at a
    small input, MARS at its own 128x64, the w8a8 SSD with and without its
    int8 depthwise convolutions): the port's count equals, exactly, a walk
    over the JAX network's jaxpr, where each `conv_general_dilated` counts
    2 x output elements x kh x kw x Cin/groups and each `dot_general`
    2 x batch x free x contracted dims; XLA's own `cost_analysis` total
    of the same jitted program is recorded beside it (a number, not an
    assertion: it also counts elementwise work);
  * one `tracker.step`: its count equals its formula
    (`tracker_step_flops`);
  * the whole chunk program: its count equals the sum of its stages, and
    two frames count twice one;
  * the dsconv kernel's reported work (`kernels.dsconv.work`) equals the
    count of the two convolutions of `dsconv_reference` and of the plain
    version `fused_dsconv` takes on the CPU.

The walk lives here: the port never imports JAX."""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import torch

import deepdish_tpu.models.ssd_q as jq
from deepdish_tpu.models import ssd_mobilenet as jssd
from deepdish_tpu.models import yolov5 as jy5
from deepdish_tpu.models.mars import MarsNet as JMarsNet
from deepdish_tpu_torch import tracker as tt
from deepdish_tpu_torch.kernels import dsconv
from deepdish_tpu_torch.models import COCO_LABELS
from deepdish_tpu_torch.models import ssd_q as pq
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models.layers import flax_default_init_
from deepdish_tpu_torch.models.mars import MarsNet
from deepdish_tpu_torch.models.ssd_mobilenet import SSDMobileNetV1
from deepdish_tpu_torch.models.yolov5 import YOLOv5s
from deepdish_tpu_torch.ops.dsconv import dsconv_reference, fused_dsconv
from deepdish_tpu_torch.tools import bench, flops_report
from deepdish_tpu_torch.utils import flops
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.timeout(300)
F32 = jnp.float32
N = 2                       # images a network call
SSD_IN = (96, 128)          # the SSD's small input
YOLO_IN = 128


def _subjaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def jaxpr_flops(jaxpr) -> int:
    """2 x the multiply-adds of every convolution and dot in `jaxpr` and
    its sub-jaxprs (a scan's body counted `length` times)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        out = eqn.outvars[0].aval.shape
        if name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec
            total += (2 * math.prod(out) * rhs[spec[1]]
                      * math.prod(rhs[d] for d in spec[2:]))
        elif name == "dot_general":
            lhs = eqn.invars[0].aval.shape
            (contract, _), _ = eqn.params["dimension_numbers"]
            total += 2 * math.prod(out) * math.prod(lhs[d] for d in contract)
        times = eqn.params.get("length", 1) if name == "scan" else 1
        for sub in _subjaxprs(list(eqn.params.values())):
            total += times * jaxpr_flops(sub)
    return total


def jax_count(fn, *args):
    """(the jaxpr walk's count, XLA's cost_analysis flops) of fn(*args)."""
    walk = jaxpr_flops(jax.make_jaxpr(fn)(*args).jaxpr)
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return walk, float(ca.get("flops", float("nan")))


def port_count(fn, *args) -> int:
    with torch.inference_mode(), flops.Count() as c:
        fn(*args)
    return c.total


def _zeros(net, example):
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), example)
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _port(net):
    flax_default_init_(net, torch.Generator().manual_seed(0))
    return net.eval()


def _ssd_q_params(quantize_dw):
    """(JAX variables, JAX qparams, port qparams) of a random SSD, with a
    fixed calibration (the count does not read the values)."""
    net = SSDMobileNetV1()
    flax_default_init_(net, torch.Generator().manual_seed(0))
    variables = pw._unflatten(pw.to_flax(net))
    paths = pq._quantized_layers(quantize_dw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "calibrate_ssd", lambda *a, **k: {p: 6.0
                                                          for p in paths})
        want = jq.quantize_ssd(variables, quantize_dw=quantize_dw)
    return variables, want, pq.prepare_qparams(pw.ssd_q_from_jax(want),
                                               "cpu")


def _nets(name):
    """(JAX function, its arguments, port function, its arguments)."""
    if name == "ssd":
        jnet = jssd.SSDMobileNetV1(compute_dtype=F32)
        v = _zeros(jnet, jnp.zeros(SSD_IN + (3,), F32))
        x = jnp.zeros((N,) + SSD_IN + (3,), F32)
        return (lambda v, x: jax.vmap(lambda im: jnet.apply(v, im))(x),
                (v, x), _port(SSDMobileNetV1()),
                (torch.zeros((N,) + SSD_IN + (3,)),))
    if name == "yolov5s":
        jnet = jy5.YOLOv5s(compute_dtype=F32)
        v = _zeros(jnet, jnp.zeros((YOLO_IN, YOLO_IN, 3), F32))
        x = jnp.zeros((N, YOLO_IN, YOLO_IN, 3), F32)
        return (lambda v, x: jax.vmap(lambda im: jnet.apply(v, im))(x),
                (v, x), _port(YOLOv5s()),
                (torch.zeros((N, YOLO_IN, YOLO_IN, 3)),))
    if name == "mars":
        jnet = JMarsNet(compute_dtype=F32)
        v = _zeros(jnet, jnp.zeros((1, 128, 64, 3), F32))
        return (jnet.apply, (v, jnp.zeros((N, 128, 64, 3), F32)),
                _port(MarsNet()), (torch.zeros((N, 128, 64, 3)),))
    dw = name == "ssd_w8a8_dw"
    variables, jqp, pqp = _ssd_q_params(dw)
    x = np.zeros((N,) + SSD_IN + (3,), np.float32)
    return (lambda x: jq.ssd_forward(variables, x, compute_dtype=F32,
                                     qparams=jqp),
            (jnp.asarray(x),),
            lambda x: pq.ssd_forward(pqp["base"], x, qparams=pqp),
            (torch.from_numpy(x),))


@pytest.mark.parametrize("name", ["ssd", "yolov5s", "mars", "ssd_w8a8",
                                  "ssd_w8a8_dw"])
def test_network_count_equals_jaxpr_walk(name, record_property):
    jfn, jargs, pfn, pargs = _nets(name)
    walk, xla = jax_count(jfn, *jargs)
    got = port_count(pfn, *pargs)
    record_property("port_flops", got)
    record_property("xla_cost_analysis_flops", xla)
    print(f"{name}: port {got}, jaxpr walk {walk}, XLA cost_analysis "
          f"{xla:.0f}")
    assert got == walk > 0


def test_quantized_depthwise_reports_its_taps():
    """With the int8 depthwise convolutions the taps' work is reported
    (no dispatch mode sees an elementwise product as a contraction)."""
    _, _, pqp = _ssd_q_params(True)
    with torch.inference_mode(), flops.Count() as c:
        pq.ssd_forward(pqp["base"], torch.zeros((1,) + SSD_IN + (3,)),
                       qparams=pqp)
    assert c.by_op()[flops.REPORTED] > 0


SMALL = dict(max_tracks=8, max_detections=4, gallery_size=8, num_labels=4)


def tracker_step_flops(cfg) -> int:
    """The contractions of one `tracker.step` at TrackerConfig `cfg`
    (T tracks, D detections, G gallery rows, F feature width): the
    gallery's cosine product (T, G, F) x (D, F); Kalman predict, mean
    (T, 8) x (8, 8)^T and F P F^T as two products of 8 x 8 matrices a
    track; Kalman update, the gain (8, 4) times the innovation and times
    its scaled transpose a track."""
    T, D, G = cfg.max_tracks, cfg.max_detections, cfg.gallery_size
    predict = 2 * T * 8 * 8 + 2 * (2 * T * 8 * 8 * 8)
    update = 2 * T * 8 * 4 + 2 * T * 8 * 4 * 8
    return 2 * T * G * D * cfg.feature_dim + predict + update


@pytest.mark.parametrize("cfg", [SMALL, bench.TRACKER],
                         ids=["small", "bench"])
def test_tracker_step_count_is_its_formula(cfg):
    cfg = tt.TrackerConfig(**cfg)
    rng = np.random.RandomState(0)
    D = cfg.max_detections
    dets = tt.Detections(
        tlwh=torch.from_numpy(rng.rand(D, 4).astype(np.float32) * 200),
        confidence=torch.ones(D), label=torch.zeros(D, dtype=torch.int32),
        feature=torch.from_numpy(rng.rand(D, 128).astype(np.float32)),
        valid=torch.ones(D, dtype=torch.bool))
    table = tt.create_table(cfg, "cpu")
    for _ in range(3):          # empty, then live tracks: the same work
        with torch.inference_mode(), flops.Count() as c:
            table, _ = tt.step(cfg, table, dets)
        assert c.total == tracker_step_flops(cfg)


@pytest.fixture(scope="module")
def fs():
    return bench.build_framestep(device="cpu", height=96, width=128,
                                 tracker=SMALL, enc_cap=2,
                                 wanted=COCO_LABELS)


def test_chunk_program_is_the_sum_of_its_stages(fs):
    two = flops_report.count(fs, 2)
    one = flops_report.count(fs, 1)
    assert two["total"] == sum(two["stages"].values()) > 0
    assert two["total"] == sum(two["by_op"].values())
    assert two["total"] == 2 * one["total"]
    assert two["stages"]["tracker"] == 2 * tracker_step_flops(fs.tracker_cfg)
    assert all(v > 0 for v in two["stages"].values())


def test_flops_report_main(fs, capsys):
    line = flops_report.main(["--chunk", "2", "--fps", "100"],
                             framestep=fs)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("{") and line["platform"] == "cpu"
    assert line["flops_per_dispatch"] == flops_report.count(fs, 2)["total"]
    assert line["peak"] == "float32" and line["peak_tflops"] == 67.0
    assert line["tflops"] == pytest.approx(line["value"] * 100 / 1e3)
    assert line["mfu"] == pytest.approx(line["tflops"] / 67.0)


@pytest.mark.parametrize("stride", [1, 2])
def test_dsconv_reported_work_equals_plain_convolutions(stride):
    b, h, w, cin, cout = 2, 11, 13, 8, 16
    rng = np.random.RandomState(stride)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(
        np.float32))
    weights = (torch.randn(3, 3, cin), torch.ones(cin), torch.zeros(cin),
               torch.randn(cin, cout), torch.ones(cout), torch.zeros(cout))
    ref = port_count(lambda: dsconv_reference(x, *weights, stride=stride))
    with torch.inference_mode(), flops.Count() as plain:
        fused_dsconv(x, *weights, stride=stride)   # the CPU's plain version
    assert dsconv.work(b, h, w, cin, cout, stride) == ref == plain.total
    ho, wo = -(-h // stride), -(-w // stride)
    assert plain.by_op()[flops.REPORTED] == 2 * b * ho * wo * cin * 9


def test_report_outside_a_count_is_a_no_op():
    flops.report(10 ** 12)
    with flops.Count() as outer:
        flops.report(7)
        with flops.Count() as inner:
            flops.report(5)
    assert (outer.total, inner.total) == (12, 5)
