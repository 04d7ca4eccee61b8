"""`tracker.streams_per_step` reads what a traced run of the port records:
the window's frames over its `framestep.tracker` ranges, 16 where the
engine's 16 streams take one batched tracker step a call (CPU, tiny size),
and every `tracker.*` metric of the cell still reads a value; on the card,
the same in the cell at its size."""
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

NAME = "tracker.streams_per_step"


def test_streams_per_step_reads_a_traced_run(monkeypatch):
    # a window of 6 calls whatever the CPU's speed: the window's clock reads
    # 1/18 s later at each look (3 looks a call), so that the walkers'
    # tracks confirm (n_init 3) and later calls run the matching cascade
    ticks = itertools.count()
    monkeypatch.setattr(win_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) / 18))
    cell = bench_tiny.tiny_cell("frcnn-16cam-live", streams=16)
    tracker = {m["name"] for m in cell.per_layer
               if m["name"].startswith("tracker.")}
    assert NAME in tracker
    res = run.run_cell(cell, 2 ** 33 + 7, 1.0, True, torch.device("cpu"),
                       0.0)
    assert res["calls"] == 6
    layer = run.per_layer(cell, res)
    assert tracker <= set(layer)
    assert all(layer[m]["value"] is not None for m in tracker)
    # the engine's 16 streams in one tracker step a call (F = 1)
    assert layer[NAME]["value"] == 16


@pytest.mark.gpu
def test_streams_per_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "frcnn-16cam-live", "--seed", str(2 ** 31 + 29), "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(bench_tiny.HERE))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m[NAME] == 16
    cell = spec.load_cell("frcnn-16cam-live", spec.benchmark_file())
    assert all(m[x["name"]] is not None for x in cell.per_layer
               if x["name"].startswith("tracker."))
