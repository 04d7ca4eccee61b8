"""FLOPs of the contractions a piece of the port runs: 2 x the multiply-adds
of every convolution and matrix product, at the shapes it runs them.

    with flops.Count() as c:
        fs.run_chunk_yuv(state, yuv)
    c.total                       # int FLOPs
    c.by_op()                     # {"convolution": ..., "mm": ..., ...}

`Count` is torch's `FlopCounterMode` (a dispatch mode: it sees every torch
op on any device; a convolution counts 2 x output elements x kh x kw x
Cin/groups, a matrix product 2 x batch x M x N x K). Work that no torch
contraction op does is reported by the code that does it, through `report`,
at its logical shape, so that the count does not depend on which
implementation runs:

  * a hand kernel reached through ctypes, which no dispatch mode sees
    (kernels/dsconv.py: its depthwise and pointwise products);
  * a contraction summed from shifted taps with elementwise ops (the plain
    dsconv's, ssd_q's and qgraph's depthwise convolutions);
  * the int8 GEMM `torch._int_mm` (models/qgraph.py `int8_matmul`, the only
    caller), whose operands are padded past cuBLASLt's size rules: it
    reports the unpadded product and the mode gives `_int_mm` no formula.

The LSAP kernel does no contraction and reports nothing. Outside a `Count`,
`report` costs one list test.
"""
from __future__ import annotations

from typing import Dict, List

from torch.utils.flop_counter import FlopCounterMode

#: the open counters, innermost last
_ACTIVE: List["Count"] = []

REPORTED = "reported"      # by_op() key of the work `report` was given


def report(flops: int) -> None:
    """Adds `flops` to every open `Count` (a no-op outside one)."""
    for c in _ACTIVE:
        c.flop_counts["Global"][REPORTED] += int(flops)


def conv(out_elements: int, taps: int, cin_per_group: int) -> int:
    """2 x output elements x kernel taps x input channels a group."""
    return 2 * int(out_elements) * int(taps) * int(cin_per_group)


class Count(FlopCounterMode):
    """FLOPs of the torch contractions inside the block, plus what `report`
    was given there."""

    def __init__(self):
        super().__init__(display=False)

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def total(self) -> int:
        return int(self.get_total_flops())

    def by_op(self) -> Dict[str, int]:
        return {str(k): int(v)
                for k, v in self.get_flop_counts().get("Global", {}).items()}
