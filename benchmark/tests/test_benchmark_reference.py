"""The comparison that decides `correct`, at tiny sizes on the CPU: the
program passes it, the lower-precision control fails it, and so does the
program with its timed path broken underneath in each way a cell can
break it."""
import numpy as np
import pytest
import torch

import bench_tiny
from harness import faults

import run

CELLS = bench_tiny.CELLS
SEED = 2 ** 31 + 7
CPU = torch.device("cpu")


def _run(cell_name, control=False, seconds=3.0):
    cell = bench_tiny.tiny_cell(cell_name)
    res = run.run_cell(cell, SEED, seconds, False, CPU, 0.0,
                       control=control)
    ok, rows = run.check.judge(res["numbers"], cell.config["limits"])
    return cell, res, ok, rows


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_equals_the_port(cell_name):
    cell, res, ok, rows = _run(cell_name)
    assert ok, rows
    assert res["detections"] > 0
    for name, value, _lim in rows:
        if name.endswith("_off"):
            assert value == 0, name
    # the tracker ran on detections, and the counters were compared
    assert res["numbers"]["track_off"] == 0
    assert res["numbers"]["count_off"] == 0


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails(cell_name):
    cell, res, ok, rows = _run(cell_name, control=True)
    assert ok, rows
    ctrl = res["numbers"]["control"]
    ctrl_ok, ctrl_rows = run.check.judge(ctrl, cell.config["limits"])
    assert not ctrl_ok, ctrl_rows


CASES = [(c, f) for c in CELLS for f in faults.for_cell(bench_tiny.cell(c))]


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell_name, fault):
    mend = faults.plant(fault)
    try:
        _cell, res, ok, rows = _run(cell_name)
    finally:
        mend()
    assert res["calls"] >= 4 and res["detections"] > 0
    assert not ok, rows
    assert np.isfinite([v for _k, v, _l in rows]).all()
