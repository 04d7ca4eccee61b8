"""One short run of each cell on the card, started as `run.py`'s command: the
last line of standard output is the result's JSON object and the run is
correct. Needs a CUDA card; skips without one. Run on the card's machine
with `python3 -m pytest -m gpu benchmark/tests -q`."""
import json
import os
import subprocess
import sys

import pytest

import bench_tiny
from harness import spec

CELLS = [w["name"] for w in spec.benchmark_file()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_short_run_prints_a_correct_result(cell_name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell_name,
         "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(bench_tiny.HERE))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"], line["checks"]
    cell = spec.load_cell(cell_name, spec.benchmark_file())
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want if m["name"] in line["metrics"]}
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
