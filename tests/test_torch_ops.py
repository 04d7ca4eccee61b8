"""Port parity of the small ops: onehot tie rules, boxes, Kalman, distance
and NMS. The same numpy inputs go to deepdish_tpu (JAX on the CPU) and to
deepdish_tpu_torch (device="cpu")."""
import pytest

jax = pytest.importorskip("jax")  # the reference side needs JAX

import numpy as np
import jax.numpy as jnp
import torch

from deepdish_tpu.ops import boxes as jboxes
from deepdish_tpu.ops import distance as jdist
from deepdish_tpu.ops import kalman as jkal
from deepdish_tpu.ops import nms as jnms
from deepdish_tpu.ops import onehot as joh
from deepdish_tpu_torch.ops import boxes as pboxes
from deepdish_tpu_torch.ops import distance as pdist
from deepdish_tpu_torch.ops import kalman as pkal
from deepdish_tpu_torch.ops import nms as pnms
from deepdish_tpu_torch.ops import onehot as poh


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tie_heavy(rng, n):
    """Scores from a tiny set of values: most entries tie with others."""
    return rng.choice(np.array([0.25, 0.5, 0.75, 0.875], np.float32), n)


# ---- onehot ordering (integer outputs: exact) ----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_onehot_orders(seed):
    rng = np.random.RandomState(seed)
    keys_i = rng.randint(0, 5, size=37).astype(np.int32)
    scores = _tie_heavy(rng, 37)
    np.testing.assert_array_equal(
        poh.stable_argsort(_t(keys_i)).numpy(),
        np.asarray(joh.stable_argsort(jnp.asarray(keys_i))))
    np.testing.assert_array_equal(
        poh.sort_values(_t(scores)).numpy(),
        np.asarray(joh.sort_values(jnp.asarray(scores))))
    pv, pi = poh.topk_desc(_t(scores), 11)
    jv, ji = joh.topk_desc(jnp.asarray(scores), 11)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        poh.argsort_desc_tie_high(_t(scores)).numpy(),
        np.asarray(joh.argsort_desc_tie_high(jnp.asarray(scores))))


def test_scatter_rows_unique_drops_out_of_range():
    rng = np.random.RandomState(3)
    base = rng.normal(size=(6, 3)).astype(np.float32)
    idx = np.array([4, 6, 0, -1, 2], np.int32)     # 6 and -1 are dropped
    upd = rng.normal(size=(5, 3)).astype(np.float32)
    got = poh.scatter_rows_unique(_t(base), _t(idx), _t(upd)).numpy()
    want = np.asarray(joh.scatter_rows_unique(
        jnp.asarray(base), jnp.asarray(np.where(idx < 0, 6, idx)),
        jnp.asarray(upd)))
    np.testing.assert_array_equal(got, want)


# ---- boxes, Kalman, distance (float32: tolerances stated) ----

def test_boxes():
    rng = np.random.RandomState(4)
    a = np.abs(rng.normal(50, 20, size=(7, 4))).astype(np.float32) + 1
    b = np.abs(rng.normal(50, 20, size=(5, 4))).astype(np.float32) + 1
    for fn in ("tlwh_to_tlbr", "tlbr_to_tlwh", "tlwh_to_xyah",
               "xyah_to_tlwh", "xyxy_to_tlwh"):
        np.testing.assert_allclose(
            getattr(pboxes, fn)(_t(a)).numpy(),
            np.asarray(getattr(jboxes, fn)(jnp.asarray(a))),
            rtol=1e-6, atol=1e-5)     # same float32 expression, one rounding
    for fn in ("iou_matrix_tlwh", "iou_matrix_tlbr_plus1"):
        np.testing.assert_allclose(
            getattr(pboxes, fn)(_t(a), _t(b)).numpy(),
            np.asarray(getattr(jboxes, fn)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6, atol=1e-6)


def test_kalman_batched():
    rng = np.random.RandomState(5)
    meas = np.c_[rng.uniform(50, 500, (6, 2)), rng.uniform(0.3, 0.8, 6),
                 rng.uniform(40, 120, 6)].astype(np.float32)
    pm, pc = pkal.initiate_v(_t(meas))
    jm, jc = jkal.initiate_v(jnp.asarray(meas))
    # float32 matrix products summed in a different order: relative 1e-5
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **tol)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **tol)
    pm, pc = pkal.predict_v(pm, pc)
    jm, jc = jkal.predict_v(jm, jc)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **tol)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **tol)
    new = meas + rng.normal(0, 2, meas.shape).astype(np.float32)
    np.testing.assert_allclose(
        pkal.gating_distance_v(pm, pc, _t(new)).numpy(),
        np.asarray(jkal.gating_distance_v(jm, jc, jnp.asarray(new))), **tol)
    pm, pc = pkal.update_v(pm, pc, _t(new))
    jm, jc = jkal.update_v(jm, jc, jnp.asarray(new))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **tol)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **tol)


def test_gallery_min_cosine():
    rng = np.random.RandomState(6)
    gal = rng.normal(size=(5, 7, 16)).astype(np.float32)
    gval = rng.uniform(size=(5, 7)) < 0.6
    gval[2] = False                                   # an empty gallery
    feats = rng.normal(size=(4, 16)).astype(np.float32)
    fval = np.array([True, False, True, True])
    got = pdist.gallery_min_cosine(_t(gal), _t(gval), _t(feats),
                                   _t(fval)).numpy()
    want = np.asarray(jdist.gallery_min_cosine(
        jnp.asarray(gal), jnp.asarray(gval), jnp.asarray(feats),
        jnp.asarray(fval)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    # 16-term float32 dot products in another order: 1e-6 absolute
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)


# ---- NMS: keep set and pick order exact, on tie-heavy scores ----

def _boxes(rng, n):
    tl = rng.randint(0, 40, size=(n, 2)).astype(np.float32)
    wh = rng.randint(4, 24, size=(n, 2)).astype(np.float32)
    return np.c_[tl, wh]


@pytest.mark.parametrize("seed", range(6))
def test_nms_tlwh_tie_heavy(seed):
    rng = np.random.RandomState(seed)
    n = 24
    tlwh = _boxes(rng, n)
    scores = _tie_heavy(rng, n)
    valid = rng.uniform(size=n) < 0.85
    po, pk = pnms.nms_tlwh(_t(tlwh), _t(scores), _t(valid), 0.6)
    jo, jk = jnms.nms_tlwh(jnp.asarray(tlwh), jnp.asarray(scores),
                           jnp.asarray(valid), 0.6)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("seed", range(6))
def test_nms_xyxy_per_class_tie_heavy(seed):
    rng = np.random.RandomState(100 + seed)
    n = 30
    tlwh = _boxes(rng, n)
    xyxy = np.c_[tlwh[:, :2], tlwh[:, :2] + tlwh[:, 2:]]
    scores = _tie_heavy(rng, n)
    classes = rng.randint(0, 3, size=n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    po, pk = pnms.nms_xyxy_per_class(_t(xyxy), _t(scores), _t(classes),
                                     _t(valid), 0.5)
    jo, jk = jnms.nms_xyxy_per_class(jnp.asarray(xyxy), jnp.asarray(scores),
                                     jnp.asarray(classes),
                                     jnp.asarray(valid), 0.5)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))


def test_nms_batched_equals_per_problem():
    """A leading batch dim solves each problem as it would alone."""
    rng = np.random.RandomState(7)
    tlwh = np.stack([_boxes(rng, 16) for _ in range(3)])
    scores = np.stack([_tie_heavy(rng, 16) for _ in range(3)])
    valid = rng.uniform(size=(3, 16)) < 0.9
    bo, bk = pnms.nms_tlwh(_t(tlwh), _t(scores), _t(valid), 0.6)
    for i in range(3):
        o, k = pnms.nms_tlwh(_t(tlwh[i]), _t(scores[i]), _t(valid[i]), 0.6)
        np.testing.assert_array_equal(bo[i].numpy(), o.numpy())
        np.testing.assert_array_equal(bk[i].numpy(), k.numpy())
