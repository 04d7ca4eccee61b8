"""Device resolution, numeric precision policy and the host-sync count.

Entry points take an explicit `device`. `None` means CUDA: the port is
written for the GPU, so a missing card is an error, never a silent switch to
the CPU. Passing `device="cpu"` (as the tests do) runs every op through its
plain PyTorch version.

Precision, set by `resolve_device` for CUDA devices:
  * float32 matmuls run in full float32
    (`torch.backends.cuda.matmul.allow_tf32 = False`): the tracker's Kalman,
    gating and cosine costs feed the tie-exact assignment solve;
  * float32 cuDNN convolutions run in full float32 too
    (`torch.backends.cudnn.allow_tf32 = False`), so a float32 model run is
    the parity configuration. The speed path runs the models in bf16
    (`models.preprocess.default_compute_dtype`), as the TPU path did.

Host syncs: eager PyTorch turns the JAX program's data-dependent loops (the
NMS fixpoint, the matching cascade, the IoU-stage branch) into Python
control flow that reads the device. Each such read goes through
`sync_bool`/`sync_int`, and each copy of outputs to the host through
`sync_numpy`; they count them in `host_syncs`, so a run can report its
syncs per frame. Each names its call site, and runs its read inside the
profiler range "framestep.sync_<site>", whose host time is the wait for
the card's queue to drain plus the copy:
  * "trk": the matching cascade's level count and early exit, the IoU
    stage's branch (tracker/matching.py);
  * "nms": the greedy NMS fixpoint (ops/nms.py);
  * "gallery": the gallery ring's pressure and overflow (tracker/types.py);
  * "outputs": outputs copied to the host (pipeline/runtime.py `to_host`,
    the tools).

Spans: `span(name)` opens every profiler range of the port. It is a
`torch.profiler.record_function` range while a profiler runs, and a shared
no-op context otherwise, so an untraced call pays one flag check a range.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

MATMUL_ALLOW_TF32 = False
CUDNN_ALLOW_TF32 = False

#: device-to-host reads made by the port's control flow since the last reset
host_syncs = 0

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range `name` while a profiler runs; else a no-op context
    (the same object every call)."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def set_precision_flags() -> None:
    torch.backends.cuda.matmul.allow_tf32 = MATMUL_ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = CUDNN_ALLOW_TF32


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> cuda. Raises when CUDA is asked for (explicitly or by
    default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepdish_tpu_torch runs on CUDA and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        set_precision_flags()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync_bool(t: torch.Tensor, site: str) -> bool:
    """A one-element tensor as a Python bool: one counted host sync, in the
    range "framestep.sync_<site>"."""
    global host_syncs
    host_syncs += 1
    with span("framestep.sync_" + site):
        return bool(t)


def sync_int(t: torch.Tensor, site: str) -> int:
    """A one-element tensor as a Python int: one counted host sync, in the
    range "framestep.sync_<site>"."""
    global host_syncs
    host_syncs += 1
    with span("framestep.sync_" + site):
        return int(t)


def sync_numpy(t: torch.Tensor, site: str) -> np.ndarray:
    """A tensor as host numpy: one counted host sync, in the range
    "framestep.sync_<site>"."""
    global host_syncs
    host_syncs += 1
    with span("framestep.sync_" + site):
        return t.cpu().numpy()
