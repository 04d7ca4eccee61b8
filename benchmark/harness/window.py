"""The timed window: a closed loop with one call in flight.

Each call hands every camera's next F frames (host I420 arrays) to the
engine's `step_chunk_yuv`; the call is done when its track outputs are on
the host, and each stream's countline counter then runs on them. A frame's
latency is its call's, from the hand-over to the outputs on the host. The
window closes with the first call that ends after `seconds`; the frame
rate is every frame of the window over all of its seconds.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch


class Window(NamedTuple):
    seconds: float            # first hand-over to the last call's end
    calls: int
    frames: int
    latency_s: List[float]    # one a call
    outs: list                # per call: the track outputs, host numpy
    states: object            # the engine's states after the last call
    counters: dict            # the port's counters over the window


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_outputs(outs):
    """The call's track outputs on the host, as numpy arrays."""
    return type(outs)(*(t.cpu().numpy() for t in outs))


def run(system, traffic, seconds: float, countings, read_counters,
        device) -> Window:
    engine, rec = system.engine, system.recorder
    S = len(countings)
    F = traffic.calls.shape[2]
    states = engine.init_states()
    _sync(device)
    lat, outs_h = [], []
    c0 = read_counters()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    calls = 0
    while True:
        rec.begin(calls)
        x = traffic.calls[calls % traffic.period]
        t_in = time.perf_counter()
        states, outs, _snaps = engine.step_chunk_yuv(states, x)
        host = host_outputs(outs)
        t_out = time.perf_counter()
        lat.append(t_out - t_in)
        for s in range(S):
            for f in range(F):
                countings[s].process(type(host)(*(a[s, f] for a in host)))
        outs_h.append(host)
        calls += 1
        if time.perf_counter() >= deadline:
            break
    t_end = time.perf_counter()
    rec.begin(None)
    c1 = read_counters()
    return Window(t_end - t0, calls, calls * S * F, lat, outs_h, states,
                  {k: c1[k] - c0[k] for k in c0})


def warm(system, traffic, n_calls: int, device) -> None:
    """`n_calls` calls on fresh states, outputs read back: every shape the
    window uses, before it."""
    engine = system.engine
    states = engine.init_states()
    for c in range(n_calls):
        states, outs, _ = engine.step_chunk_yuv(
            states, traffic.calls[c % traffic.period])
        host_outputs(outs)
    _sync(device)


def frame_latencies_ms(win: Window, frames_per_call: int) -> np.ndarray:
    """Every frame's latency in ms (each frame takes its call's)."""
    return np.repeat(np.asarray(win.latency_s) * 1e3, frames_per_call)
