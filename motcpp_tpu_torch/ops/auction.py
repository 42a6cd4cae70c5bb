"""Jacobi auction for masked, cost-limited assignment: the plain version.

Counterpart of ``motcpp_tpu/ops/auction_pallas.py::_auction_kernel`` over a
leading batch of P problems. It is the CPU path of
``solve_lap_masked(impl="auction_pallas")`` and the reference that the
CUDA kernel (``ops/auction_cuda.py``) is held to on the card, so its
arithmetic is the kernel's:

  * costs are clipped to +-1e6 and NaN costs become 1e7 (clipping first,
    as the TPU kernel does, so +-inf become +-1e6);
  * benefit ``b = thresh - cost`` on row- and column-valid pairs, NEG
    elsewhere; ``eps = max(max(b_max, 1e-6) * EPS_FRAC, 1e-7)``;
  * each round every unassigned row takes its best column ``j*`` (first
    index among equal values), opts out for good if ``v1 <= 0``, else
    bids ``(p[j*] + (v1 - v2)) + eps`` with ``v2`` floored at 0;
  * each column takes its highest bid, the lowest row among equal bids;
    the evicted row becomes unassigned again;
  * rounds repeat while a valid row is unassigned, at most MAX_ROUNDS.

A solved problem is a fixed point of a round, so running every problem
of the batch until the slowest converges gives each problem the matching
it would get alone.
"""

from __future__ import annotations

import torch

NEG = -1e30
BIG = 1e7
COST_CLIP = 1e6
EPS_FRAC = 1.0 / 64.0
MAX_ROUNDS = 1000


def condition_cost(cost: torch.Tensor) -> torch.Tensor:
    """Clip to +-COST_CLIP, then replace what is still non-finite (NaN)
    by BIG, in the TPU kernel's order."""
    cost = cost.to(torch.float32).clamp(-COST_CLIP, COST_CLIP)
    return torch.where(torch.isfinite(cost), cost,
                       torch.full_like(cost, BIG))


def solve_lap_auction(cost: torch.Tensor, row_mask: torch.Tensor,
                      col_mask: torch.Tensor, thresh: torch.Tensor):
    """(P, K, N) cost, (P, K) and (P, N) bool masks, (P,) thresholds ->
    (P, K) row2col and (P, N) col2row, int32, -1 for unmatched."""
    P, K, N = cost.shape
    dev = cost.device
    cost = condition_cost(cost)
    th = thresh.to(torch.float32).reshape(P, 1, 1)
    pair_ok = row_mask[:, :, None] & col_mask[:, None, :]
    neg = torch.full_like(cost, NEG)
    b = torch.where(pair_ok, th - cost, neg)
    b_max = torch.where(pair_ok, b, torch.zeros_like(b)).amax(dim=(1, 2))
    eps = (b_max.clamp_min(1e-6) * EPS_FRAC).clamp_min(1e-7)[:, None]

    col_ids = torch.arange(N, dtype=torch.int32, device=dev)
    row_ids = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    p = torch.zeros((P, N), dtype=torch.float32, device=dev)
    r2c = torch.where(row_mask, -1, -2).to(torch.int32)
    c2r = torch.full((P, N), -1, dtype=torch.int32, device=dev)
    rounds = 0
    # masked rows start at -2 and never bid, so -1 marks a valid row
    # that is still unassigned
    while rounds < MAX_ROUNDS and bool((r2c == -1).any()):
        unassigned = r2c == -1
        v = b - p[:, None, :]
        v1 = v.amax(dim=2)
        j_star = torch.where(v == v1[:, :, None], col_ids, N).amin(dim=2)
        best = col_ids == j_star[:, :, None]  # (P, K, N)
        v2 = torch.where(best, neg, v).amax(dim=2).clamp_min(0.0)

        bidding = unassigned & (v1 > 0.0)
        r2c = torch.where(unassigned & (v1 <= 0.0), -2, r2c)
        bid = (torch.gather(p, 1, j_star.long()) + (v1 - v2)) + eps
        bid_mat = torch.where(bidding[:, :, None] & best, bid[:, :, None], neg)
        best_bid = bid_mat.amax(dim=1)  # (P, N)
        has_bid = best_bid > NEG / 2
        winner = torch.where((bid_mat == best_bid[:, None, :])
                             & has_bid[:, None, :], row_ids, K).amin(dim=1)

        p = torch.where(has_bid, best_bid, p)
        evicted = (has_bid[:, None, :] & (c2r[:, None, :] == row_ids)).any(2)
        r2c = torch.where(evicted, -1, r2c)
        c2r = torch.where(has_bid, winner, c2r)
        win = has_bid[:, None, :] & (winner[:, None, :] == row_ids)
        won_col = torch.where(win, col_ids, N).amin(dim=2)
        r2c = torch.where(win.any(dim=2), won_col, r2c)
        rounds += 1

    row2col = torch.where(r2c >= 0, r2c, -1)
    # rows at -1 equal no column id
    first = torch.where(row2col[:, :, None] == col_ids, row_ids, K).amin(1)
    col2row = torch.where(first < K, first, -1)
    return row2col, col2row
