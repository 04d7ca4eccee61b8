"""The port's LSAP: the plain PyTorch solver against the JAX solver
(deepdish_tpu.ops.assignment.solve_lsap), the Pallas kernel in interpret
mode (as tests/test_assignment_pallas.py runs it) and scipy. Assignments
are integers: all comparisons are exact. The CUDA kernel's own test is in
test_torch_gpu.py."""
import pytest

jax = pytest.importorskip("jax")  # the reference side needs JAX

import numpy as np
import jax.numpy as jnp
import torch
from scipy.optimize import linear_sum_assignment

from deepdish_tpu.ops.assignment import solve_lsap as jax_solve
from deepdish_tpu.ops.assignment_pallas import solve_lsap_pallas_batched
from deepdish_tpu_torch.ops.assignment import solve_lsap, solve_lsap_plain

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
