"""The port's LSAP: the plain PyTorch solver against the JAX solver
(deepdish_tpu.ops.assignment.solve_lsap), the Pallas kernel in interpret
mode (as tests/test_assignment_pallas.py runs it) and scipy, and the
pieces of the CUDA kernel's formulation that the plain solver mirrors (the
order-preserving key, the one-reduction tie rule, the launch plan).
Assignments are integers: all comparisons are exact. The CUDA kernel's own
test is in test_torch_gpu.py."""
import pytest

jax = pytest.importorskip("jax")  # the reference side needs JAX

import numpy as np
import jax.numpy as jnp
import torch
from scipy.optimize import linear_sum_assignment

from deepdish_tpu.ops.assignment import solve_lsap as jax_solve
from deepdish_tpu.ops.assignment_pallas import solve_lsap_pallas_batched
from deepdish_tpu_torch.kernels import lsap
from deepdish_tpu_torch.ops.assignment import (key_value, order_key,
                                               scan_pick, solve_lsap,
                                               solve_lsap_plain)

K = 16
_jax_solve = jax.jit(jax_solve)


def _pad(cost, k=K):
    out = np.full((k, k), 7e7, np.float32)
    out[:cost.shape[0], :cost.shape[1]] = cost
    return out


def _scipy(cost, k=K):
    want = np.full((k,), -1, np.int32)
    if cost.size:
        rows, cols = linear_sum_assignment(cost.astype(np.float64))
        want[rows] = cols
    return want


def _cases(rng):
    dyadic = np.array([0.125, 0.25, 0.25 + 2.0 ** -12, 0.75], np.float32)
    cases = []
    for shape in [(1, 1), (3, 3), (5, 8), (8, 5), (12, 12), (16, 3),
                  (3, 16), (16, 16)]:
        for _ in range(3):                               # random
            cases.append(rng.uniform(0, 1, size=shape).astype(np.float32))
    for _ in range(12):                                  # tie-heavy
        shape = (rng.randint(1, K + 1), rng.randint(1, K + 1))
        cases.append(rng.choice(dyadic, size=shape))
    for _ in range(6):                                   # tracker clamp
        c = rng.uniform(0, 0.4, size=(rng.randint(1, K + 1),
                                      rng.randint(1, K + 1)))
        c[c > 0.2] = 0.2 + 1e-5
        cases.append(c.astype(np.float32))
    cases += [np.zeros((0, 5), np.float32), np.zeros((5, 0), np.float32),
              np.zeros((0, 0), np.float32)]              # empty
    return cases


@pytest.fixture(scope="module")
def batch():
    cases = _cases(np.random.RandomState(0))
    costs = np.stack([_pad(c) for c in cases])
    sizes = np.array([c.shape for c in cases], np.int32)
    return cases, costs, sizes


def test_plain_matches_scipy_and_jax(batch):
    cases, costs, sizes = batch
    got = solve_lsap_plain(torch.from_numpy(costs),
                           torch.from_numpy(sizes)).numpy()
    for i, cost in enumerate(cases):
        np.testing.assert_array_equal(got[i], _scipy(cost),
                                      err_msg=f"case {i} cost=\n{cost}")
        np.testing.assert_array_equal(
            got[i], np.asarray(_jax_solve(jnp.asarray(costs[i]),
                                          int(sizes[i, 0]),
                                          int(sizes[i, 1]))))


def test_plain_matches_pallas_interpret(batch):
    cases, costs, sizes = batch
    got = solve_lsap_plain(torch.from_numpy(costs),
                           torch.from_numpy(sizes)).numpy()
    pallas = np.asarray(solve_lsap_pallas_batched(
        jnp.asarray(costs), jnp.asarray(sizes[:, 0]),
        jnp.asarray(sizes[:, 1]), interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_batched_equals_single(batch):
    cases, costs, sizes = batch
    got = solve_lsap_plain(torch.from_numpy(costs),
                           torch.from_numpy(sizes)).numpy()
    for i in (0, 7, 30, len(cases) - 1):
        one = solve_lsap_plain(torch.from_numpy(costs[i:i + 1]),
                               torch.from_numpy(sizes[i:i + 1])).numpy()[0]
        np.testing.assert_array_equal(one, got[i])


def test_dispatch_cpu_takes_plain(batch):
    _, costs, sizes = batch
    np.testing.assert_array_equal(
        solve_lsap(torch.from_numpy(costs), torch.from_numpy(sizes)).numpy(),
        solve_lsap_plain(torch.from_numpy(costs),
                         torch.from_numpy(sizes)).numpy())


@pytest.mark.parametrize("n_rows,n_cols", [(6, 6), (4, 6), (6, 4)])
def test_plain_structured(n_rows, n_cols):
    """A cheapest-diagonal problem assigns row r to column r, and every row
    past the smaller side (and past n_rows) is -1, in either orientation."""
    cost = (np.ones((n_rows, n_cols), np.float32) -
            np.eye(n_rows, n_cols, dtype=np.float32))
    out = solve_lsap_plain(torch.from_numpy(_pad(cost))[None],
                           torch.tensor([[n_rows, n_cols]], dtype=torch.int32))
    n = min(n_rows, n_cols)
    want = np.full((K,), -1, np.int32)
    want[:n] = np.arange(n)
    np.testing.assert_array_equal(out[0].numpy(), want)
    np.testing.assert_array_equal(out[0].numpy(), _scipy(cost))


def test_order_key_is_monotone():
    """The kernel's int32 key orders floats as < does, over finite values,
    +-inf and subnormals; -0.0 and +0.0 (equal under ==) share a key; the
    key maps back to the value."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    f32 = st.floats(width=32, allow_nan=False)

    @hyp.settings(max_examples=400, deadline=None)
    @hyp.given(f32, f32)
    @hyp.example(-0.0, 0.0)
    @hyp.example(-1e-45, 0.0)
    @hyp.example(-1e-45, -0.0)
    @hyp.example(1e-45, 1.1754942e-38)
    @hyp.example(-float("inf"), -3.4028235e38)
    @hyp.example(3.4028235e38, float("inf"))
    def check(a, b):
        x = torch.tensor([a, b], dtype=torch.float32)
        ka, kb = order_key(x).tolist()
        fa, fb = x.tolist()
        assert (ka < kb) == (fa < fb) and (ka == kb) == (fa == fb)
        back = key_value(order_key(x)).view(torch.int32)
        assert torch.equal(back,
                           torch.where(x == 0, 0.0, x).view(torch.int32))

    check()


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 65])
def test_scan_pick_matches_three_reductions(k):
    """The one max over tie keys picks the scan position that the three
    reductions of the Pallas kernel and the block-per-matrix CUDA kernel pick (min value, first
    tied position, last tied unmatched position), on random scans with
    forced ties (dyadic values, +-0, +inf), with the plain solver's tie
    constant K and the kernel's 32 * ceil(K / 32)."""
    rng = np.random.RandomState(k)
    n = 300
    vals = np.array([0.125, 0.25, 0.5, -0.0, 0.0, np.inf], np.float32)
    value = rng.choice(vals, size=(n, k)).astype(np.float32)
    matched = rng.uniform(size=(n, k)) < rng.uniform(size=(n, 1))
    num_rem = rng.randint(1, k + 1, size=n)
    pos = np.full((n, k), -1)
    for b in range(n):           # the scan: num_rem columns, any order
        cols = rng.permutation(k)[:num_rem[b]]
        pos[b, cols] = np.arange(num_rem[b])
    live = pos >= 0
    want_idx, want_low = [], []
    for b in range(n):
        at = {p: c for c, p in enumerate(pos[b]) if p >= 0}
        c_at = np.array([value[b, at[p]] for p in range(num_rem[b])])
        low = c_at.min()
        tied = [p for p in range(num_rem[b]) if c_at[p] == low]
        unm = [p for p in tied if not matched[b, at[p]]]
        want_idx.append(max(unm) if unm else min(tied))
        want_low.append(low)
    for tie in (k, 32 * -(-k // 32)):
        lowest, idx = scan_pick(order_key(torch.from_numpy(value)),
                                torch.from_numpy(pos), torch.from_numpy(live),
                                torch.from_numpy(matched), tie)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        np.testing.assert_array_equal(key_value(lowest).numpy(), want_low)


H100_SMEM_OPTIN = 227 * 1024      # opt-in shared memory a block
# the block-per-matrix design's capacity: K * K * 4 + 9 * K * 4 bytes plus
# 384 static within the H100's opt-in shared memory
BLOCK_CAPACITY = max(k for k in range(1, 1025) if
                     k * k * 4 + 9 * k * 4 + 384 <= H100_SMEM_OPTIN)


@pytest.mark.parametrize("k", [1, 8, 31, 32, 33, 64, 65, 128, 236, 256])
def test_launch_plan_covers_the_batch(k):
    """One block of one warp a matrix: q = ceil(K / 32) columns a lane, a
    block for every matrix of the batch and none beyond it, and shared
    memory for the cost at an odd row stride and u, within the H100's
    227 KB wherever K is within the capacity."""
    for b in (1, 5, 64, 133, 301, 1000):
        p = lsap.plan(b, k)
        assert p.q == -(-k // 32) and 1 <= p.q <= lsap.MAX_Q
        assert p.grid == b
        stride = k if k % 2 else k + 1
        assert p.smem_bytes == 4 * (k * stride + k)
        assert (p.smem_bytes <= H100_SMEM_OPTIN) == (
            k <= lsap.capacity(H100_SMEM_OPTIN))
    with pytest.raises(ValueError):
        lsap.plan(1, 0)
    with pytest.raises(ValueError):
        lsap.plan(1, 32 * lsap.MAX_Q + 1)


def test_capacity_not_below_the_block_kernel():
    """Every K that the block-per-matrix design took fits one warp's block,
    and the largest K that fits (`capacity`, which `max_capacity` applies
    to the card's opt-in shared memory) is at least that design's on the
    H100."""
    assert BLOCK_CAPACITY == 236
    assert all(lsap.plan(1, k).smem_bytes <= H100_SMEM_OPTIN
               for k in range(1, BLOCK_CAPACITY + 1))
    assert lsap.capacity(H100_SMEM_OPTIN) == 240 >= BLOCK_CAPACITY
    assert lsap.capacity(0) == 0
    assert lsap.capacity(1 << 30) == 32 * lsap.MAX_Q


@pytest.mark.parametrize("k", [33, 64])
def test_plain_at_the_lane_boundary(k):
    """The reformulated plain solver at K = 33 and 64 (one and two columns
    past a warp's 32 lanes, and the tracker's capacity) against the JAX XLA
    solver, the Pallas kernel in interpret mode and scipy."""
    rng = np.random.RandomState(k)
    dyadic = np.array([0.125, 0.25, 0.25 + 2.0 ** -12, 0.75], np.float32)
    cases = [rng.uniform(0, 1, size=(k, k)).astype(np.float32),
             rng.uniform(0, 1, size=(k - 1, k)).astype(np.float32),
             rng.uniform(0, 1, size=(k, 5)).astype(np.float32),
             rng.choice(dyadic, size=(k, k)),
             rng.choice(dyadic, size=(32, k)),
             np.zeros((0, k), np.float32)]
    for shape in [(k, k), (32, 33), (33, 32), (24, 24)]:
        c = rng.uniform(0, 0.4, size=shape)
        c[c > 0.2] = 0.2 + 1e-5
        cases.append(c.astype(np.float32))
    costs = np.stack([_pad(c, k) for c in cases])
    sizes = np.array([c.shape for c in cases], np.int32)
    got = solve_lsap_plain(torch.from_numpy(costs),
                           torch.from_numpy(sizes)).numpy()
    pallas = np.asarray(solve_lsap_pallas_batched(
        jnp.asarray(costs), jnp.asarray(sizes[:, 0]),
        jnp.asarray(sizes[:, 1]), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for i, cost in enumerate(cases):
        np.testing.assert_array_equal(got[i], _scipy(cost, k),
                                      err_msg=f"case {i} shape {cost.shape}")
        np.testing.assert_array_equal(
            got[i], np.asarray(_jax_solve(jnp.asarray(costs[i]),
                                          int(sizes[i, 0]),
                                          int(sizes[i, 1]))))
