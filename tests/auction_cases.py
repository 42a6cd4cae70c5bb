"""Seeded auction inputs of the classes the CUDA auction kernel's design
relies on (ties, zero benefits, empty problems, edge shapes, the round
cap). tests/test_torch_lap.py holds the port's plain auction against the
JAX Pallas kernel on them; tests/test_torch_cuda.py holds the CUDA kernel
against the plain auction on them. This module imports numpy only.

``edge_case(name)`` -> (cost, row_mask, col_mask, thresh) as numpy
arrays of shapes (P, K, N), (P, K), (P, N), (P,).
"""

import numpy as np


def _random(rng, P, K, N, mask_p=0.8):
    cost = rng.random((P, K, N)).astype(np.float32)
    rm = rng.random((P, K)) < mask_p
    cm = rng.random((P, N)) < mask_p
    th = np.full(P, 0.8, np.float32)
    return cost, rm, cm, th


def _row_ties(rng):
    # costs on a grid of quarters: a row's best value repeats, and its
    # first column must win
    cost, rm, cm, th = _random(rng, 6, 8, 12)
    cost = (rng.integers(0, 4, cost.shape) / 4).astype(np.float32)
    cost[:, :, 5] = cost[:, :, 2]
    return cost, rm, cm, th


def _bid_ties(rng):
    # duplicated rows bid the same value on the same column; the lower
    # row must win
    cost, rm, cm, th = _random(rng, 6, 10, 6, mask_p=0.9)
    cost[:, 1::2] = cost[:, 0::2]
    rm[:, :4] = True
    return cost, rm, cm, th


def _zero_benefit(rng):
    # cost == thresh gives benefit exactly 0: a row whose best benefit is
    # 0 opts out (v1 <= 0), and a zero second best floors v2
    cost, rm, cm, th = _random(rng, 6, 8, 8)
    th[:] = 0.5
    cost[rng.random(cost.shape) < 0.4] = 0.5
    cost[0, 0] = 0.5
    cost[1, :, 1:] = 0.5
    return cost, rm, cm, th


def _signed_zero(rng):
    # benefits of 0 reached as +0.0 and as -0.0: thresh +0.0 or -0.0,
    # costs +0.0 or -0.0 beside negative costs
    P, K, N = 6, 8, 8
    cost = np.where(rng.random((P, K, N)) < 0.5, np.float32(0.0),
                    np.float32(-0.0)).astype(np.float32)
    neg = rng.random((P, K, N)) < 0.3
    cost[neg] = -rng.random(int(neg.sum())).astype(np.float32)
    th = np.array([0.0, -0.0] * (P // 2), np.float32)
    rm = rng.random((P, K)) < 0.9
    cm = rng.random((P, N)) < 0.9
    return cost, rm, cm, th


def _empty_mixed(rng):
    # problems with no valid row, with no valid column, and with
    # neither, between ordinary ones
    cost, rm, cm, th = _random(rng, 8, 12, 8)
    rm[1] = False
    cm[3] = False
    rm[5] = cm[5] = False
    rm[6, 1:] = False
    cm[7, 1:] = False
    return cost, rm, cm, th


def _shape(P, K, N, mask_p=0.8):
    return lambda rng: _random(rng, P, K, N, mask_p)


def _round_cap(rng):
    # 18 rows on 17 equal columns: every round one price rises by eps, so
    # the war outlasts MAX_ROUNDS (1000); beside it an ordinary problem
    cost, rm, cm, th = _random(rng, 2, 18, 17)
    cost[0] = 0.0
    rm[0] = cm[0] = True
    th[0] = 1.0
    return cost, rm, cm, th


EDGE_CASES = {
    "row_ties": _row_ties,
    "bid_ties": _bid_ties,
    "zero_benefit": _zero_benefit,
    "signed_zero": _signed_zero,
    "empty_mixed": _empty_mixed,
    "k1": _shape(4, 1, 6, 1.0),
    "n1": _shape(4, 6, 1, 1.0),
    "n16": _shape(4, 24, 16),
    "n33": _shape(4, 40, 33),
    "n128": _shape(2, 40, 128),
    "k256": _shape(2, 256, 24),
    "round_cap": _round_cap,
}


def edge_case(name):
    """Inputs of one class, seeded by its name."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cost, rm, cm, th = EDGE_CASES[name](rng)
    return (np.ascontiguousarray(cost, np.float32), np.ascontiguousarray(rm),
            np.ascontiguousarray(cm), np.ascontiguousarray(th, np.float32))
