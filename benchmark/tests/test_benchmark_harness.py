"""The harness finds cells, configurations, traffic, families and metrics
by name, keeps BENCHMARK.json well formed, and runs a cell that was added
as data files alone (CPU, tiny sizes)."""
import json
import os
import re
import shutil

import pytest
import torch

import bench_tiny
from harness import spec, tracing

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark_file()


def test_benchmark_json_is_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [m["name"] for m in BENCH["end_to_end"]][-1] == "setup_s"
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert c["reduced"] == spec.load_json(
            os.path.join(spec.ROOT, c["file"]))["reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in configs
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_cell_pieces_are_found_by_name(cell):
    c = bench_tiny.cell(cell)
    fam = spec.family(c.config)
    for attr in ("make_weights", "program_detector", "install_taps",
                 "Checker", "detector_flops", "input_size", "labels"):
        assert hasattr(fam, attr)
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert set(c.config["limits"]) >= {"rgb_off", "post_off", "filter_off",
                                       "mars_gap", "track_off", "count_off",
                                       "det_gap"}


def test_a_cell_added_as_data_files_runs_unedited(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    new = dict(spec.load_json(os.path.join(
        spec.HERE, "traffic", "16cam-720p-walkers.json")), streams=8)
    with open(root / "benchmark" / "traffic" / "8cam-new.json", "w") as f:
        json.dump(new, f)
    bench["workloads"].append({"name": "frcnn-8cam-new",
                               "config": "frcnn_r101_640-mars",
                               "traffic": "8cam-new", "chips": 1,
                               "why": "a cell made of data alone"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    monkeypatch.setattr(spec, "HERE", str(root / "benchmark"))
    monkeypatch.setattr(spec, "ROOT", str(root))
    cell = bench_tiny.shrink(spec.load_cell("frcnn-8cam-new",
                                            spec.benchmark_file()))
    assert cell.traffic["name"] == "8cam-new"
    res = run.run_cell(cell, 5, 1.0, False, torch.device("cpu"), 0.0)
    assert res["frames"] % 4 == 0 and res["frames"] >= 4
    ok, _ = run.check.judge(res["numbers"], cell.config["limits"])
    assert ok


def test_result_lines_of_a_traced_run():
    cell = bench_tiny.tiny_cell("frcnn-16cam-live")
    res = run.run_cell(cell, 2 ** 33 + 1, 1.0, True, torch.device("cpu"),
                       0.0)
    e2e = run.end_to_end(cell, dict(res, latency_ms=res["latency_ms"]))
    assert set(e2e) == {"fps", "latency_ms_p90", "setup_s"}
    layer = run.per_layer(cell, res)
    # counters read on any device; device times only from a card's trace
    assert "engine.host_syncs_per_frame" in layer
    assert "lsap.launches_per_frame" in layer
    assert res["flops"]["step"] > res["flops"]["detector"] > 0
    assert 0.0 <= res["trace"]["busy_s"]


def test_trace_reduction_merges_and_attributes():
    assert tracing._merge([(5, 7), (1, 3), (2, 4), (7, 8)]) == [[1, 4],
                                                                [5, 8]]
    r = tracing._Ranges()
    r.add("framestep.tracker", 10, 20)
    r.add("framestep.tracker", 30, 40)
    r.add("ssd.net", 0, 5)
    r.freeze()
    assert [n for _s, n in r.containing(15)] == ["framestep.tracker"]
    assert r.containing(25) == []
    assert [n for _s, n in r.containing(3)] == ["ssd.net"]
