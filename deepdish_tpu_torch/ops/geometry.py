"""2-D segment intersection, vectorized for countline crossing detection.

Port of deepdish_tpu/ops/geometry.py, the equivalent of
tools/intersection.py:4-30 in the reference: the reference tests one segment
pair at a time in Python; here a whole polyline (track path history,
fixed-length ring buffer) is tested against a countline in one vector op, on
tensors of any leading shape and without branches.

`_EPS` is float64's machine epsilon, as in the JAX file, also where the
inputs are float32: the parallel and colinear decisions compare |r x s| and
|(q - p) x r| with that same constant, so both packages decide alike.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float64).eps)


def _tensor(x) -> torch.Tensor:
    """A tensor as is; a numpy array or list as a tensor of its own dtype
    (Python floats become float64, as numpy makes them)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def segments_intersect(p, pr, q, qs, eps: float = _EPS):
    """Whether segment p->pr intersects q->qs. All inputs (..., 2).

    Mirrors the parametric cross-product test of tools/intersection.py:4-24,
    including the colinear-overlap case, branch-free over the leading
    shape."""
    p, pr, q, qs = (_tensor(x) for x in (p, pr, q, qs))
    r = pr - p
    s = qs - q
    rxs = _cross2(r, s)
    qmp = q - p
    qpxr = _cross2(qmp, r)
    parallel = torch.abs(rxs) < eps

    # general (non-parallel) case
    den = torch.where(parallel, torch.ones_like(rxs), rxs)
    t = _cross2(qmp, s) / den
    u = qpxr / den
    general_hit = (0.0 <= t) & (t <= 1.0) & (0.0 <= u) & (u <= 1.0)

    # colinear case: project q and qs onto r, test interval overlap
    rdrr_den = torch.sum(r * r, dim=-1)
    rdrr = r / torch.where(rdrr_den == 0.0, torch.ones_like(rdrr_den),
                           rdrr_den)[..., None]
    t0 = torch.sum(qmp * rdrr, dim=-1)
    t1 = t0 + torch.sum(s * rdrr, dim=-1)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    colinear_hit = ~((hi < 0.0) | (lo > 1.0))

    colinear = parallel & (torch.abs(qpxr) < eps)
    return torch.where(parallel, colinear & colinear_hit, general_hit)


def crossing_direction(p, pr, q):
    """Sign of the cross product (pr-p) x (q-p): which side of segment p->pr
    the point q lies on. Used for pos/neg countline direction as in
    deepdish.py:1071-1078 (reference computes np.cross of the countline
    vector with the path step)."""
    p, pr, q = (_tensor(x) for x in (p, pr, q))
    return torch.sign(_cross2(pr - p, q - p))


def any_intersection(p1, q1, pts, valid=None):
    """Whether segment p1->q1 intersects any consecutive segment of polyline
    `pts` (K, 2). `valid` (K,) bool marks real points in a fixed-size ring
    buffer; a polyline segment counts only when both endpoints are valid.

    Equivalent of tools/intersection.py:26-30 over a fixed-capacity path."""
    pts = _tensor(pts)
    a = pts[:-1]
    b = pts[1:]
    p1 = _tensor(p1).to(a.dtype)
    q1 = _tensor(q1).to(a.dtype)
    hits = segments_intersect(p1.expand(a.shape), q1.expand(a.shape), a, b)
    if valid is not None:
        valid = _tensor(valid)
        hits = hits & valid[:-1] & valid[1:]
    return torch.any(hits)
