"""What the reference needs of a device module: resolve a device, read a
one-element tensor on the host, and a profiler range that records
nothing (the reference runs outside the benchmark's traced window)."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def sync_bool(t: torch.Tensor) -> bool:
    return bool(t)


def sync_int(t: torch.Tensor) -> int:
    return int(t)


def record_function(name: str):
    return contextlib.nullcontext()
