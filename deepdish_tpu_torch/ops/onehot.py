"""Ordering, gather and scatter primitives with the JAX package's tie rules.

The JAX package (deepdish_tpu/ops/onehot.py) expresses these as one-hot
rank contractions because XLA's sort/gather lower to serial loops on a TPU.
On the GPU they are plain sorts, gathers and scatters; what must carry over
is the exact order among equal keys, since it decides the NMS pick order
and the order of the assignment problem's rows:

  * `stable_argsort` / `sort_values`: ascending, equal keys keep index
    order (onehot.py:43-55);
  * `topk_desc`: descending, ties to the LOWER index (onehot.py:75) — a
    stable descending sort. `torch.topk` is not used: its tie order is
    unspecified;
  * `argsort_desc_tie_high`: descending, ties to the HIGHER index, the
    reference NMS pick order (onehot.py:91) — the reverse of the stable
    ascending order;
  * `argsort_desc_tie_low`: descending, ties to the LOWER index, the
    tf.image.non_max_suppression pick order of the Faster R-CNN stages
    (onehot.py:104) — a stable descending sort.

All functions act on the last dimension and accept leading batch dims.
Float keys must not hold -0.0 next to +0.0 or NaN: the CUDA radix sort
orders those by bit pattern where the JAX rank contraction calls them
equal. The pipeline's scores are sigmoids and scrubbed zeros (+0.0), and
its integer keys are exact.
"""
from __future__ import annotations

import torch


def stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, dim=-1, stable=True).indices


def sort_values(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, dim=-1, stable=True).values


def topk_desc(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest, descending, ties -> lower index.
    With k above the row length the JAX package's rank-matrix top-k gives
    index 0 (and its score) in the slots past it; so does this."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    extra = k - scores.shape[-1]
    if extra > 0:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (extra,))], -1)
        vals = torch.cat([vals, scores[..., :1].expand(
            scores.shape[:-1] + (extra,))], -1)
    return vals[..., :k], idx[..., :k]


def argsort_desc_tie_high(scores: torch.Tensor) -> torch.Tensor:
    """Descending argsort, ties broken by HIGHER index first."""
    return torch.flip(stable_argsort(scores), dims=(-1,))


def argsort_desc_tie_low(scores: torch.Tensor) -> torch.Tensor:
    """Descending argsort, ties broken by LOWER index first."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (..., N, C), idx (..., K) -> (..., K, C): out[..., k, :] =
    values[..., idx[..., k], :] (the batched onehot.py:65)."""
    return values.gather(-2, idx[..., None].expand(
        idx.shape + values.shape[-1:]))


def scatter_rows_unique(base: torch.Tensor, idx: torch.Tensor,
                        upd: torch.Tensor) -> torch.Tensor:
    """Copy of `base` with out[idx[k]] = upd[k]; idx entries in range must
    be unique, entries outside [0, base.shape[0]) are dropped.

    Dropped entries are routed to a spare row appended past the end, so the
    scatter needs no host sync to filter them."""
    n = base.shape[0]
    ok = (idx >= 0) & (idx < n)
    dest = torch.where(ok, idx, torch.full_like(idx, n)).long()
    out = torch.cat([base, base[:1]], dim=0)
    out[dest] = upd.to(base.dtype)
    return out[:n]


def flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(S, M) row indices into S tables of n rows each -> (S * M,) indices
    into their S * n rows laid end to end (`flatten(0, 1)`), for
    `scatter_rows_unique` over a batch: entry s of a row in [0, n) moves to
    s * n + row, any other goes to S * n, past the end, and is dropped."""
    s = idx.shape[0]
    offset = torch.arange(s, device=idx.device)[:, None] * n
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx + offset, s * n).reshape(-1)
