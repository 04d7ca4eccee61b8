"""Cells, configurations, traffic mixes, families and per-layer metrics,
found by the names `BENCHMARK.json` gives them.

A configuration is `configs/<name>.json`, a traffic mix
`traffic/<name>.json`, a model family `families/<family>.py` (named by the
configuration's "family" key) and a per-layer metric `metrics/<name>.py`
(with a `read(ctx)` function), all under the benchmark's directory. Nothing
here names a cell, so a cell added as data files runs as it is.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict       # configs/<name>.json, with "name"
    traffic: dict      # traffic/<name>.json, with "name"
    end_to_end: list   # BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict) -> Cell:
    """The cell `name` of `bench` with its configuration and traffic."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = dict(load_json(os.path.join(ROOT, conf["file"])),
                  name=w["config"])
    traffic = dict(load_json(os.path.join(HERE, "traffic",
                                          w["traffic"] + ".json")),
                   name=w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    layer = [m for m in bench["per_layer"] if _listed(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def _load_module(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def family(config: dict):
    """The module `families/<config["family"]>.py`."""
    name = config["family"]
    return _load_module(os.path.join(HERE, "families", name + ".py"),
                        "families_" + name)


def metric_reader(name: str):
    """`read(ctx)` of `metrics/<name>.py`."""
    mod = _load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "metric_" + name.replace(".", "_"))
    return mod.read
