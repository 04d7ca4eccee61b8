"""Appearance distance: gallery nearest-neighbour cosine distance.

Port of deepdish_tpu/ops/distance.py:16-71. The (T, G, F) x (D, F) product
is one batched matmul (cuBLAS in float32; TF32 is off, see device.py),
as the JAX package left it to XLA outside any kernel.
"""
from __future__ import annotations

import torch


def _normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.where(n == 0.0, torch.ones_like(n), n)


def gallery_min_cosine(gallery: torch.Tensor, gallery_valid: torch.Tensor,
                       features: torch.Tensor,
                       feat_valid: torch.Tensor | None = None,
                       data_is_normalized: bool = False) -> torch.Tensor:
    """(..., T, G, F) gallery, (..., T, G) validity, (..., D, F) features
    -> (..., T, D) min cosine distance over valid gallery rows; +inf for an
    empty gallery. A leading axis (streams) batches the product."""
    g = gallery if data_is_normalized else _normalize(gallery)
    f = features if data_is_normalized else _normalize(features)
    sims = torch.einsum("...tgf,...df->...tgd", g, f)
    dists = 1.0 - sims
    dists = torch.where(gallery_valid[..., None], dists,
                        torch.full_like(dists, float("inf")))
    out = dists.amin(dim=-2)
    if feat_valid is not None:
        out = torch.where(feat_valid[..., None, :], out,
                          torch.full_like(out, float("inf")))
    return out
