"""Tiny versions of the benchmark's cells, for the CPU tests: the same
files, code paths and labels, at sizes a test run can hold; the walkers
keep about their share of the frame, so that the fitted read-out
(`harness/readout.py`) detects them as at the cells' sizes."""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.append(p)

from harness import spec  # noqa: E402

TRAFFIC = dict(streams=4, height=96, width=128, block_w=12, block_h=12,
               step_px=4, row_top=8, row_pitch=30, start_x_right=28,
               start_x_left=88, walkers=3, walk_frames=16, shift_px=8,
               line_x=64, warm_calls=1, check_streams=2, check_share=0.5)

FRCNN = dict(input_size=128, stem_features=16, block_units=[1, 1, 1, 1],
             block_features=[32, 64, 128, 256], rpn_features=32,
             pre_nms_topk=256, max_proposals=64, anchor_base=48.0)
# walkers of about the tiny Faster R-CNN's smallest anchors (12-24 px)
FRCNN_WALKERS = dict(block_w=32, block_h=24, row_top=4, start_x_right=20,
                     start_x_left=76)


def shrink(cell, **traffic):
    """`cell` at the tiny size."""
    tr = {**cell.traffic, **TRAFFIC, **traffic}
    if tr["background_frames"]:
        tr["background_frames"] = 3
    cfg = dict(cell.config)
    if cfg["family"] == "faster_rcnn":
        cfg["detector"] = dict(cfg["detector"], **FRCNN)
        tr.update(FRCNN_WALKERS)
    return cell._replace(config=cfg, traffic=tr)


# a cell that PERF.md keeps under its open questions, with its
# configuration and traffic files still in the benchmark: tested here, so
# that a later change brings it back with a `BENCHMARK.json` entry alone
HELD = {"ssd-16cam-1080p-bgsub": ("ssd_mbv1_300-mars",
                                  "16cam-1080p-walkers-bgsub")}


def bench() -> dict:
    """BENCHMARK.json with the held cells added."""
    b = json.loads(json.dumps(spec.benchmark_file()))
    for name, (config, traffic) in HELD.items():
        b["configs"].append({"name": config,
                             "file": f"benchmark/configs/{config}.json"})
        b["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1})
    return b


CELLS = [w["name"] for w in bench()["workloads"]]


def cell(name: str):
    """The cell `name` of BENCHMARK.json or of the held ones."""
    return spec.load_cell(name, bench())


def tiny_cell(name: str, **traffic):
    """The cell `name` (`cell`) at the tiny size."""
    return shrink(cell(name), **traffic)
