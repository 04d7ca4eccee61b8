"""Full pipeline-state checkpointing.

Port of deepdish_tpu/pipeline/checkpoint.py. The reference's only resume
mechanism is counters-from-log (deepdish.py:546-558); here the whole state
(Kalman table, galleries, label votes, MOG2 model) is one .npz, written
with the JAX package's keys (`table/<field>`, `bg/<field>`,
`__counter__<name>`, `__frame_count__`), so a checkpoint written by either
CLI restores in the other and carries tracker and MOG2 state across.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import tracker as tt
from ..ops import bgsub
from .framestep import PipelineState


def save_state(path: str, state: PipelineState, counters: dict,
               frame_count: int):
    flat = {"__frame_count__": np.asarray(frame_count)}
    for k, v in counters.items():
        flat[f"__counter__{k}"] = np.asarray(v)
    for name, t in zip(tt.TrackTable._fields, state.table):
        flat[f"table/{name}"] = t.cpu().numpy()
    if state.bg is not None:
        for name, t in zip(bgsub.MOG2State._fields, state.bg):
            flat[f"bg/{name}"] = t.cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **flat)
    os.replace(tmp, path)


def load_state(path: str, template: PipelineState):
    """Returns (state, counters, frame_count), the state on the template's
    device; shapes must match the template (same capacities/config)."""
    dev = template.table.mean.device
    with np.load(path) as f:
        loaded = {n: f[f"table/{n}"] for n in tt.TrackTable._fields}
        # The tracker stores appearance rows unit-normalized; normalizing
        # here is idempotent for new checkpoints and upgrades checkpoints
        # that stored raw features.
        for key in ("gallery", "pending"):
            arr = loaded[key].astype(np.float32, copy=False)
            n = np.linalg.norm(arr, axis=-1, keepdims=True)
            loaded[key] = (arr / np.where(n == 0.0, 1.0, n)
                           ).astype(loaded[key].dtype)
        table = tt.TrackTable(*[torch.from_numpy(np.array(loaded[n])).to(dev)
                                for n in tt.TrackTable._fields])
        bg = None
        if template.bg is not None and "bg/weight" in f.files:
            bg = bgsub.MOG2State(*[torch.from_numpy(np.array(f[f"bg/{n}"]))
                                   .to(dev)
                                   for n in bgsub.MOG2State._fields])
        counters = {k[len("__counter__"):]: int(f[k])
                    for k in f.files if k.startswith("__counter__")}
        frame_count = int(f["__frame_count__"])
    for a, b in zip(table, template.table):
        if a.shape != b.shape:
            raise ValueError(
                "checkpoint capacities do not match the configured tracker")
    return PipelineState(table, bg), counters, frame_count
