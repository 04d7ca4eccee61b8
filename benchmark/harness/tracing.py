"""The traced window's reduction: device time by kernel and by the
program's profiler ranges, host time of the ranges, the device's busy
time and its idle gaps by what the host was doing.

Reads the raw events of `torch.profiler` (kineto) without building the
profiler's event tree, which is slow on a window of many calls. A kernel
is put under a range when the host call that launched it (CUDA runtime
event with the kernel's correlation id, else the operator linked to it)
started inside that range.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

#: characters of a kernel's name kept in the breakdown
NAME_CHARS = 120

#: range names of the port whose times the metrics read, by prefix
RANGE_PREFIXES = ("framestep.", "frcnn.", "ssd.", "yolov5.", "yolov3.",
                  "efficientdet.")


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Ranges:
    """Same-name ranges (which do not nest in themselves), sorted."""

    def __init__(self):
        self.by_name = defaultdict(list)

    def add(self, name, s, e):
        self.by_name[name].append((s, e))

    def freeze(self):
        for v in self.by_name.values():
            v.sort()
        self.starts = {k: [s for s, _ in v] for k, v in self.by_name.items()}

    def containing(self, t):
        """Names of the ranges open at host time t, with their starts."""
        hits = []
        for name, starts in self.starts.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and self.by_name[name][i][1] >= t:
                hits.append((self.by_name[name][i][0], name))
        return hits


def reduce(prof, top: int = 10) -> dict:
    """{"ranges": {name: {"host_s", "device_s", "count"}}, "kernels":
    {name: device_s}, "busy_s", "device_ops", "idle_gaps", "first_ns",
    "last_ns"} of a finished profile."""
    events = prof.profiler.kineto_results.events()
    ranges = _Ranges()
    launch_ns = {}     # correlation id -> host start of the launching call
    op_ns = {}
    kernels = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            s = e.start_ns()
            if e.is_user_annotation() and name.startswith(RANGE_PREFIXES):
                ranges.add(name, s, s + e.duration_ns())
            elif name.startswith(("cuda", "cu")):
                launch_ns[e.correlation_id()] = s
            else:
                op_ns[e.correlation_id()] = s
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            kernels.append(e)
    ranges.freeze()
    host = {name: sum(e - s for s, e in v)
            for name, v in ranges.by_name.items()}
    device = defaultdict(int)
    by_kernel = defaultdict(int)
    intervals = []
    for k in kernels:
        s, d = k.start_ns(), k.duration_ns()
        intervals.append((s, s + d))
        by_kernel[k.name()] += d
        t = launch_ns.get(k.correlation_id())
        if t is None:
            t = op_ns.get(k.linked_correlation_id())
        if t is None:
            continue
        for _start, name in ranges.containing(t):
            device[name] += d
    busy = _merge(intervals)
    gaps = defaultdict(int)
    for (s0, e0), (s1, _e1) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        hits = ranges.containing(mid)
        gaps[max(hits)[1] if hits else "host"] += s1 - e0
    names = set(host) | set(device)
    return {
        "ranges": {n: {"host_s": host.get(n, 0) / 1e9,
                       "device_s": device.get(n, 0) / 1e9,
                       "count": len(ranges.by_name.get(n, ()))}
                   for n in names},
        "kernels": {n: v / 1e9 for n, v in by_kernel.items()},
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_ops": [[n[:NAME_CHARS], v / 1e9] for n, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, v / 1e9] for n, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
        "first_ns": busy[0][0] if busy else 0,
        "last_ns": busy[-1][1] if busy else 0,
    }


def range_sum(trace: dict, prefixes, key: str) -> float:
    """Sum of `key` over the ranges whose names start with `prefixes`."""
    return sum(v[key] for n, v in trace["ranges"].items()
               if n.startswith(tuple(prefixes)))
