"""Port parity: assignment solvers of motcpp_tpu_torch against the JAX
solvers on the same seeded inputs. Matchings are integers and must be
identical, not close.

  * the port's exact JV against ``motcpp_tpu.ops.lap.solve_lap_masked``
    on the input classes of tests/test_lap.py;
  * the port's plain auction (the CPU path of impl="auction_pallas")
    against the JAX Pallas kernel in interpret mode and against the jnp
    auction, including the dense near-tie class of
    tests/test_auction.py::test_worst_case_random_costs_regression, and
    against the Pallas kernel on the classes the CUDA kernel's design
    relies on (tests/auction_cases.py: ties, zero benefits of either
    sign, empty problems, K or N of 1, N of 16, 33 and 128, K of 256,
    a problem that hits MAX_ROUNDS).

The CUDA kernel is held against the plain auction in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auction_cases import EDGE_CASES, edge_case
from motcpp_tpu.ops.auction import solve_lap_auction as jax_auction
from motcpp_tpu.ops.auction_pallas import solve_lap_auction_pallas
from motcpp_tpu.ops.lap import solve_lap_masked as jax_lap
from motcpp_tpu_torch.ops import auction, auction_cuda
from motcpp_tpu_torch.ops.lap import solve_lap_masked

import torch_threads  # noqa: F401  (torch at one thread)


def problems(seed, P, R, C, kind="uniform", mask_p=(0.8, 0.8)):
    rng = np.random.default_rng(seed)
    cost = rng.random((P, R, C)).astype(np.float32)
    if kind == "negative":
        cost = cost - 1.0
    if kind == "inf":
        cost[rng.random((P, R, C)) < 0.2] = np.inf
    rm = rng.random((P, R)) < mask_p[0]
    cm = rng.random((P, C)) < mask_p[1]
    return cost, rm, cm


def port(cost, rm, cm, thresh, impl):
    r2c, c2r = solve_lap_masked(torch.from_numpy(cost), torch.from_numpy(rm),
                                torch.from_numpy(cm), thresh, impl=impl)
    assert r2c.dtype == c2r.dtype == torch.int32
    return r2c.numpy(), c2r.numpy()


def jax_batched(fn, cost, rm, cm, thresh):
    th = np.broadcast_to(np.float32(thresh), (cost.shape[0],))
    r2c, c2r = jax.jit(jax.vmap(fn))(jnp.asarray(cost), jnp.asarray(rm),
                                     jnp.asarray(cm), jnp.asarray(th))
    return np.asarray(r2c), np.asarray(c2r)


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("shape", [(4, 4), (7, 3), (3, 7), (12, 12), (1, 9)])
@pytest.mark.parametrize("thresh", [0.3, 0.7, 1.5])
def test_jv_matches_jax(shape, thresh):
    cost, rm, cm = problems(sum(shape), 5, *shape, mask_p=(1.0, 1.0))
    cost2, rm2, cm2 = problems(sum(shape) + 1, 5, *shape)
    cost, rm, cm = (np.concatenate(x) for x in ((cost, cost2), (rm, rm2),
                                                 (cm, cm2)))
    assert_same(port(cost, rm, cm, thresh, "jv"),
                jax_batched(lambda c, r, m, t: jax_lap(c, r, m, t),
                            cost, rm, cm, thresh))


@pytest.mark.parametrize("kind", ["negative", "inf"])
def test_jv_matches_jax_negative_and_inf_costs(kind):
    cost, rm, cm = problems(7, 6, 6, 6, kind=kind)
    assert_same(port(cost, rm, cm, 0.5, "jv"),
                jax_batched(lambda c, r, m, t: jax_lap(c, r, m, t),
                            cost, rm, cm, 0.5))


def test_jv_all_masked_and_per_problem_thresholds():
    cost, rm, cm = problems(8, 4, 5, 6)
    rm[0] = False
    cm[1] = False
    th = np.array([0.3, 0.5, 0.7, 0.9], np.float32)
    r2c, c2r = solve_lap_masked(torch.from_numpy(cost), torch.from_numpy(rm),
                                torch.from_numpy(cm), torch.from_numpy(th))
    assert (r2c[:2] == -1).all() and (c2r[:2] == -1).all()
    for p in range(4):
        want = jax_lap(jnp.asarray(cost[p]), jnp.asarray(rm[p]),
                       jnp.asarray(cm[p]), float(th[p]))
        np.testing.assert_array_equal(r2c[p].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(c2r[p].numpy(), np.asarray(want[1]))


AUCTION_CASES = {
    # tests/test_auction.py::test_pallas_auction_matches_jnp
    "masked_12x8": (dict(P=5, R=12, C=8), 0.7),
    "negative": (dict(P=6, R=6, C=6, kind="negative"), 0.3),
    "inf": (dict(P=6, R=10, C=7, kind="inf"), 0.5),
    # the dense near-tie class of test_worst_case_random_costs_regression
    "near_tie": (dict(P=64, R=64, C=32, mask_p=(0.5, 0.6)), 0.9),
}


@pytest.mark.parametrize("case", sorted(AUCTION_CASES) + sorted(EDGE_CASES))
@pytest.mark.parametrize("impl", ["auction", "auction_pallas"])
def test_plain_auction_matches_jax_pallas_kernel(case, impl):
    if case in AUCTION_CASES:
        spec, thresh = AUCTION_CASES[case]
        cost, rm, cm = problems(len(case), **spec)
        rm[0] = False  # one empty problem
    else:
        cost, rm, cm, thresh = edge_case(case)
    want = jax_batched(lambda c, r, m, t: solve_lap_auction_pallas(c, r, m, t),
                       cost, rm, cm, thresh)
    th = torch.from_numpy(np.broadcast_to(np.float32(thresh), (len(cost),)).copy())
    assert_same(port(cost, rm, cm, th, impl), want)
    assert_same(want, jax_batched(lambda c, r, m, t: jax_auction(c, r, m, t),
                                  cost, rm, cm, thresh))


def test_kernel_wrapper_takes_plain_version_on_cpu():
    cost, rm, cm = problems(3, 8, 16, 8)
    args = (torch.from_numpy(cost), torch.from_numpy(rm),
            torch.from_numpy(cm), torch.full((8,), 0.8))
    before = auction_cuda.LAUNCHES
    assert_same(auction_cuda.solve(*args), auction.solve_lap_auction(*args))
    assert auction_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad", ["rows", "cols", "dtype", "mask", "strided",
                                 "thresh", "smem"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    P, K, N = 2, 8, 4
    cost = torch.rand(P, K, N)
    rm = torch.ones(P, K, dtype=torch.bool)
    cm = torch.ones(P, N, dtype=torch.bool)
    th = torch.full((P,), 0.5)
    if bad == "rows":
        cost, rm = torch.rand(P, 257, N), torch.ones(P, 257, dtype=torch.bool)
    elif bad == "cols":
        cost, cm = torch.rand(P, K, 257), torch.ones(P, 257, dtype=torch.bool)
    elif bad == "dtype":
        cost = cost.double()
    elif bad == "mask":
        rm = rm.to(torch.uint8)
    elif bad == "strided":
        cost = torch.rand(P, N, K).transpose(1, 2)
    elif bad == "smem":  # K and N each in range, the tile past 227 KB
        cost = torch.rand(P, 256, 185)
        rm = torch.ones(P, 256, dtype=torch.bool)
        cm = torch.ones(P, 185, dtype=torch.bool)
    else:
        th = th[:1]
    with pytest.raises(ValueError):
        auction_cuda.solve(cost, rm, cm, th)


@pytest.mark.parametrize("K,N", [(188, 254), (256, 184), (186, 256)])
def test_kernel_wrapper_takes_the_largest_tiles_that_fit(K, N):
    """The most K * N the kernel takes, the most N at K=256 and the most
    K at N=256: each fits a CTA's shared memory and one more row or
    column does not."""
    assert auction_cuda.smem_bytes(K, N) <= auction_cuda.MAX_SMEM
    for k, n in ((K + 1, N), (K, N + 1)):
        if k <= auction_cuda.MAX_K and n <= auction_cuda.MAX_N:
            assert auction_cuda.smem_bytes(k, n) > auction_cuda.MAX_SMEM
    cost, rm, cm = problems(K + N, 2, K, N)
    args = (torch.from_numpy(cost), torch.from_numpy(rm),
            torch.from_numpy(cm), torch.full((2,), 0.8))
    assert_same(auction_cuda.solve(*args), auction.solve_lap_auction(*args))
