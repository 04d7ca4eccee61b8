"""The port's zoo-artifact battery (deepdish_tpu_torch/tools/zoo_validate.py)
against the JAX tool (tools/zoo_validate.py, `main` called in this process)
on the CPU, on the structural files the JAX tests build with tensorflow's
converter: tests/test_pipeline_real_tflite.py `_make_full_ssd_tflite` as
float, dynamic-range int8, full-integer (so the integer step runs the
port's executor against tf.lite's reference kernels) and with the
TFLite_Detection_PostProcess op, and tests/test_convert.py's Keras mirror of MARS as a float .tflite. Both
batteries run with --skip-drive and give the same status at every step
and the same exit code; one drive step runs through the port's CLI under
--device cpu; a missing file exits 2 in both."""
import importlib.util
import os

import pytest

jax = pytest.importorskip("jax")

from deepdish_tpu_torch.tools import zoo_validate as pzoo
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.timeout(300)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_zoo_validate", os.path.join(ROOT, "tools", "zoo_validate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jzoo():
    """The JAX tool, its converter's tracer bound to
    test_torch_tflite_ssd.jax_trace (the net's init jitted, the trace
    cached per net: the same slots, signatures included)."""
    from deepdish_tpu.models import convert as jcv
    from test_torch_tflite_ssd import jax_trace
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcv, "trace_slots", jax_trace)
        yield _jax_tool()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    from test_convert import _keras_mars, _randomize_keras_bn
    from test_pipeline_real_tflite import _make_full_ssd_tflite
    d = tmp_path_factory.mktemp("zoo")
    out = {"float": str(_make_full_ssd_tflite(d)),
           "int8": str(_make_full_ssd_tflite(d, quantize=True)),
           "full_int8": str(_make_full_ssd_tflite(d, full_int8=True)),
           "postprocess": str(_make_full_ssd_tflite(d, postprocess=True))}
    model = _keras_mars(tf)
    _randomize_keras_bn(model)
    out["mars"] = str(d / "mars-small128.tflite")
    with open(out["mars"], "wb") as f:
        f.write(tf.lite.TFLiteConverter.from_keras_model(model).convert())
    return out


def _battery(tool, argv):
    tool.RESULTS.clear()
    rc = tool.main(argv)
    return rc, [(step, status) for step, status, _ in tool.RESULTS]


# the JAX battery's integer step runs its executor eagerly: ~1,600 XLA
# compiles on the full-integer file, 110 s alone and ~190 s under a loaded
# parallel run
@pytest.mark.timeout(600)
@pytest.mark.parametrize("kind", ["float", "int8", "full_int8",
                                  "postprocess", "mars"])
def test_statuses_match_jax(files, jzoo, kind, capsys):
    path = files[kind]
    want = _battery(jzoo, [path, "--skip-drive"])
    got = _battery(pzoo, [path, "--skip-drive", "--device", "cpu"])
    assert got == want
    steps = dict(got[1])
    if kind == "mars":
        assert steps["convert"] == "PASS" and "embed" in steps
    else:
        assert steps["parse"] == steps["convert"] == "PASS"
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith('{"artifact"')


def test_drive_through_the_port_cli(files):
    rc, steps = _battery(pzoo, [files["float"], "--device", "cpu"])
    assert rc == 0 and dict(steps)["drive"] == "PASS"


def test_missing_file_exits_2(jzoo, tmp_path):
    path = str(tmp_path / "nope.tflite")
    assert jzoo.main([path]) == 2
    assert pzoo.main([path, "--device", "cpu"]) == 2
