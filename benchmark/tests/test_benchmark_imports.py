"""Nothing the harness or the reference imports is JAX, jaxlib, flax or the
JAX package (top-level names compared whole: the port's name begins with
the JAX package's), and the reference imports nothing of the port."""
import glob
import os
import subprocess
import sys

import bench_tiny

BENCH_DIR = bench_tiny.HERE
FORBIDDEN = ("jax", "jaxlib", "flax", "deepdish_tpu")


def _loaded_after(code: str, cwd=None):
    """Top-level names of the modules loaded after `code` runs in a fresh
    interpreter."""
    prog = (f"import sys; sys.path[:0] = [{BENCH_DIR!r}, "
            f"{os.path.dirname(BENCH_DIR)!r}]\n{code}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=cwd, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return eval(out.stdout.strip().splitlines()[-1])


def _modules(sub):
    return [os.path.splitext(os.path.relpath(p, BENCH_DIR))[0].replace(
        os.sep, ".") for p in glob.glob(os.path.join(BENCH_DIR, sub, "*.py"))
            if not p.endswith("__init__.py")]


def test_reference_imports_neither_jax_nor_the_port():
    code = "\n".join(f"import {m}" for m in _modules("reference")
                     + _modules("reference/tracker"))
    names = _loaded_after(code)
    assert not set(names) & set(FORBIDDEN + ("deepdish_tpu_torch",))


def test_harness_and_a_run_load_no_jax():
    code = ("import torch, run, control\n"
            "from harness import spec\n"
            "for m in spec.benchmark_file()['per_layer']:\n"
            "    spec.metric_reader(m['name'])\n"
            "for c in spec.benchmark_file()['configs']:\n"
            "    spec.family(spec.load_json(spec.ROOT + '/' + c['file']))\n"
            "import bench_tiny\n"
            "cell = bench_tiny.tiny_cell('frcnn-16cam-live')\n"
            "run.run_cell(cell, 3, 0.5, False, torch.device('cpu'), 0.0)\n"
            "assert run.forbidden_modules() == []")
    names = _loaded_after(
        f"sys.path.append({os.path.join(BENCH_DIR, 'tests')!r})\n" + code)
    assert "deepdish_tpu_torch" in names
    assert not set(names) & set(FORBIDDEN)
    assert run_forbidden_is_whole_name()


def run_forbidden_is_whole_name():
    sys.modules.setdefault("deepdish_tpu_torch_x", sys)
    import run
    try:
        return "deepdish_tpu_torch_x" not in run.forbidden_modules()
    finally:
        del sys.modules["deepdish_tpu_torch_x"]


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run raises before any result."""
    import shutil
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json"),
                tmp_path)
    prog = ("import sys; sys.path[:0] = ['benchmark', 'benchmark/tests']\n"
            "import torch, run, bench_tiny\n"
            "cell = bench_tiny.tiny_cell('frcnn-16cam-live')\n"
            "run.run_cell(cell, 3, 0.5, False, torch.device('cpu'), 0.0)\n"
            "print('RESULT')")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "RESULT" not in out.stdout
    assert "deepdish_tpu_torch" in out.stderr
