"""The port stands alone: deepdish_tpu_torch and chip_smoke.py import no
jax, no flax, nothing of deepdish_tpu and nothing of the repository's
root tools/ (nor tools/_timing.py, which those scripts put on the path),
its entry points need a card
unless the caller asks for the CPU, the CLI's modules, the host TFLite
executor and the multi-stream, MOT and measuring tools import cv2 and PIL
only inside the functions that need them (the card's machine has
neither), no module imports tensorflow or h5py outside a function (the
weight readers need them only for the files they read), and none imports
flatbuffers at all (the TFLite readers parse the files with numpy)."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deepdish_tpu_torch")
_BANNED = ("jax", "flax", "deepdish_tpu", "tools", "_timing")
# modules that the CLI imports with --disable-graphics --streaming 0
_NO_TOP_LEVEL = ("cv2", "PIL")
_HOST_LAZY = [os.path.join(PKG, *p) for p in (
    ("pipeline", "runtime.py"), ("pipeline", "elements.py"),
    ("pipeline", "mjpeg.py"), ("models", "registry.py"),
    ("models", "tflite_host.py"), ("tools", "multistream_demo.py"),
    ("tools", "mot_features.py"), ("tools", "bench.py"),
    ("tools", "profile_components.py"), ("tools", "flops_report.py"),
    ("tools", "profile_micro.py"), ("tools", "coldstart_probe.py"),
    ("tools", "zoo_validate.py"))]


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in _BANNED


def test_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("deepdish_tpu_torch", "kernels", "lsap.py") in names
    assert os.path.join("deepdish_tpu_torch", "pipeline", "runtime.py") \
        in names
    for module in (("models", "qgraph.py"), ("models", "mars_q.py"),
                   ("models", "ssd_q.py"), ("ops", "intmath.py"),
                   ("parallel", "__init__.py"), ("parallel", "multistream.py"),
                   ("parallel", "temporal.py"), ("parallel", "grid.py"),
                   ("tools", "multistream_demo.py"),
                   ("tools", "mot_features.py"), ("ops", "geometry.py"),
                   ("tools", "bench.py"), ("tools", "profile_components.py"),
                   ("tools", "flops_report.py"), ("tools", "profile_micro.py"),
                   ("tools", "coldstart_probe.py"),
                   ("tools", "zoo_validate.py"), ("utils", "flops.py")):
        assert os.path.join("deepdish_tpu_torch", *module) in names
    assert len(names) > 30


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def _top_level_imports(tree):
    """Modules imported at module level (not inside a function)."""
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Try):
            names += _top_level_imports(ast.Module(body=node.body,
                                                   type_ignores=[]))
    return names


@pytest.mark.parametrize("path", _HOST_LAZY,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_top_level_cv2_or_pil(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _top_level_imports(tree)
           if m.split(".")[0] in _NO_TOP_LEVEL]
    assert not bad, f"{path} imports {bad} at module level"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_tensorflow_and_h5py_only_inside_functions(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    inside = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside.update(id(n) for n in ast.walk(fn))
    bad = []
    for node in ast.walk(tree):
        if id(node) in inside:
            continue
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            bad.append(node.module or "")
    bad = [m for m in bad if m.split(".")[0] in ("tensorflow", "h5py")]
    assert not bad, f"{path} imports {bad} outside a function"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_flatbuffers_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            bad.append(node.module or "")
    bad = [m for m in bad if m.split(".")[0] == "flatbuffers"]
    assert not bad, f"{path} imports {bad}"


def test_import_pulls_no_jax():
    code = ("import sys, deepdish_tpu_torch.pipeline, "
            "deepdish_tpu_torch.models, deepdish_tpu_torch.kernels.lsap, "
            "deepdish_tpu_torch.pipeline.counting, "
            "deepdish_tpu_torch.pipeline.main, "
            "deepdish_tpu_torch.pipeline.checkpoint, "
            "deepdish_tpu_torch.ops.bgsub, deepdish_tpu_torch.ops.colorspace, "
            "deepdish_tpu_torch.utils.native, "
            "deepdish_tpu_torch.kernels.dsconv, deepdish_tpu_torch.ops.dsconv, "
            "deepdish_tpu_torch.tools.probe_dsconv, "
            "deepdish_tpu_torch.models.convert, "
            "deepdish_tpu_torch.models.tflite_meta, "
            "deepdish_tpu_torch.models.tflite_host, "
            "deepdish_tpu_torch.models.saved_model, "
            "deepdish_tpu_torch.models.faster_rcnn, "
            "deepdish_tpu_torch.models.qgraph, "
            "deepdish_tpu_torch.models.mars_q, "
            "deepdish_tpu_torch.models.ssd_q, "
            "deepdish_tpu_torch.ops.intmath, "
            "deepdish_tpu_torch.ops.geometry, deepdish_tpu_torch.parallel, "
            "deepdish_tpu_torch.tools.multistream_demo, "
            "deepdish_tpu_torch.tools.mot_features, "
            "deepdish_tpu_torch.tools.bench, "
            "deepdish_tpu_torch.tools.profile_components, "
            "deepdish_tpu_torch.tools.flops_report, "
            "deepdish_tpu_torch.tools.profile_micro, "
            "deepdish_tpu_torch.tools.coldstart_probe, "
            "deepdish_tpu_torch.tools.zoo_validate, "
            "deepdish_tpu_torch.utils.flops\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'deepdish_tpu', 'tools', '_timing', 'cv2', "
            "'PIL', 'tensorflow', 'h5py', 'flatbuffers')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_need_cuda_unless_cpu():
    from deepdish_tpu_torch import tracker as pt
    from deepdish_tpu_torch.models import (create_box_encoder,
                                           create_detector)
    from deepdish_tpu_torch.pipeline import FrameStep
    from deepdish_tpu_torch.tools import bench, probe_dsconv
    from deepdish_tpu_torch.tools import (coldstart_probe, flops_report,
                                          profile_components, profile_micro,
                                          zoo_validate)
    cfg = pt.TrackerConfig(max_tracks=4, max_detections=2, feature_dim=128,
                           gallery_size=8, pending_size=2)
    det = create_detector("ssd_mobilenet", device="cpu")
    enc = create_box_encoder("dummy", device="cpu")
    fs = FrameStep(det, enc, cfg, ["person"], (32, 48), device="cpu")
    assert fs.init_state().table.state.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA defaults are valid here")
    from deepdish_tpu_torch.ops import bgsub
    from deepdish_tpu_torch.parallel import make_grid_mesh, make_mesh
    for call in (lambda: create_detector("ssd_mobilenet"),
                 lambda: create_detector("yolov5s"),
                 lambda: create_detector("yolov3"),
                 lambda: create_detector("efficientdet-lite0"),
                 lambda: create_detector("faster_rcnn"),
                 lambda: bgsub.init_state(8, 8),
                 lambda: create_box_encoder("mars"),
                 lambda: create_box_encoder("dummy"),
                 lambda: pt.create_table(cfg),
                 lambda: FrameStep(det, enc, cfg, ["person"], (32, 48)),
                 lambda: make_mesh(),
                 lambda: make_grid_mesh(1, 1),
                 lambda: probe_dsconv.main([]),
                 lambda: bench.main([]),
                 lambda: bench.main(["--latency"]),
                 lambda: bench.main(["--streams", "16"]),
                 lambda: profile_components.main([]),
                 lambda: flops_report.main([]),
                 lambda: profile_micro.main([]),
                 lambda: coldstart_probe.main([]),
                 lambda: coldstart_probe.main(["--cold"]),
                 lambda: zoo_validate.main(["detect.tflite"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_lsap_wrapper_refuses_cpu_tensors():
    from deepdish_tpu_torch.kernels import lsap
    costs = torch.zeros((1, 4, 4))
    sizes = torch.zeros((1, 2), dtype=torch.int32)
    before = lsap.launches
    with pytest.raises(ValueError, match="CUDA"):
        lsap.solve(costs, sizes)
    assert lsap.launches == before


def test_dsconv_wrapper_refuses_cpu_tensors():
    from deepdish_tpu_torch.kernels import dsconv
    x = torch.zeros((1, 4, 4, 8))
    weights = (torch.zeros((3, 3, 8)), torch.ones(8), torch.zeros(8),
               torch.zeros((8, 16)), torch.ones(16), torch.zeros(16))
    before = dsconv.launches
    with pytest.raises(ValueError, match="CUDA"):
        dsconv.fused(x, *weights, stride=1)
    assert dsconv.launches == before
