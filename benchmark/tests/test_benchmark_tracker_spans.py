"""The tracker's stage metrics read what a traced run of the port records:
its `framestep.trk_*` and `framestep.sync_trk` ranges (CPU, tiny size), and
on the card the cascade's levels within its LSAP launches."""
import itertools
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import bench_tiny
from harness import spec
from harness import window as win_mod

import run

STAGES = ["tracker.predict.host_ms_per_frame",
          "tracker.cascade.host_ms_per_frame",
          "tracker.iou.host_ms_per_frame",
          "tracker.update.host_ms_per_frame"]
NEW = STAGES + ["tracker.cascade_levels_per_frame",
                "tracker.sync_wait_ms_per_frame"]


def test_the_stage_metrics_read_a_traced_run(monkeypatch):
    # a window of 6 calls whatever the CPU's speed: the window's clock reads
    # 1/18 s later at each look (3 looks a call), so that the walkers'
    # tracks confirm (n_init 3) and later calls run the matching cascade
    ticks = itertools.count()
    monkeypatch.setattr(win_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) / 18))
    cell = bench_tiny.tiny_cell("frcnn-16cam-live")
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    res = run.run_cell(cell, 2 ** 33 + 7, 1.0, True, torch.device("cpu"),
                       0.0)
    assert res["calls"] == 6
    layer = run.per_layer(cell, res)
    assert set(NEW) <= set(layer)
    total = layer["tracker.host_ms_per_frame"]["value"]
    stages = sum(layer[m]["value"] for m in STAGES)
    assert 0 < stages <= total
    assert layer["tracker.cascade_levels_per_frame"]["value"] > 0
    assert 0 < layer["tracker.sync_wait_ms_per_frame"]["value"] < total


@pytest.mark.gpu
def test_cascade_levels_are_lsap_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "frcnn-16cam-live", "--seed", str(2 ** 31 + 23), "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(bench_tiny.HERE))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(m)
    assert 0 < m["tracker.cascade_levels_per_frame"] <= \
        m["lsap.launches_per_frame"]
    assert sum(m[k] for k in STAGES) <= m["tracker.host_ms_per_frame"]
    cell = spec.load_cell("frcnn-16cam-live", spec.benchmark_file())
    assert {x["name"] for x in cell.per_layer} <= set(m)
