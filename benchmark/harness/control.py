"""The lower-precision control: a copy of a reference net whose every
convolution and dense layer takes its weight and its input rounded to
float8 e4m3 (each tensor scaled by its largest magnitude to e4m3's range
of 448 first), the precision step below the configurations' bf16. Put in
the program's place, it has to fail the comparison."""
from __future__ import annotations

import copy

import torch
from torch import nn

E4M3_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's
    dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def fp8_copy(net: nn.Module) -> nn.Module:
    q = copy.deepcopy(net)
    for m in q.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                m.weight.copy_(to_fp8(m.weight))
            m.register_forward_pre_hook(
                lambda mod, args: (to_fp8(args[0]),) + tuple(args[1:]))
    return q
