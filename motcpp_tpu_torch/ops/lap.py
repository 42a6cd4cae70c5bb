"""Masked linear assignment with a cost limit, over a batch of problems.

Counterpart of ``motcpp_tpu/ops/lap.py``. ``solve_lap_masked`` takes P
problems at once, ``(P, R, C)``, and dispatches on ``impl``:

  * ``"jv"``: the exact shortest-augmenting-path Jonker-Volgenant solver
    below, on the reference's cost-limit semantics (a pair is matched
    only if that beats leaving both ends unmatched at ``thresh``);
  * ``"auction"``: the plain Jacobi auction of ``ops/auction.py``;
  * ``"auction_pallas"``: the auction kernel, ``ops/auction_cuda.py``
    (the name is the JAX package's, so configs and flags carry over).

As in the JAX solver, the (R, C) problem is augmented with R private
dummy columns at cost ``thresh`` (row i may take only dummy i), so every
row is assigned in an (R, C+R) rectangular problem. The batch runs in
lockstep, as ``jax.vmap`` runs the JAX solver: a problem whose search has
ended keeps its state while the others go on.
"""

from __future__ import annotations

import math

import torch

from motcpp_tpu_torch.ops import auction, auction_cuda
from motcpp_tpu_torch.ops.auction import BIG

IMPLS = ("jv", "auction", "auction_pallas")  # solve_lap_masked's impl


def _augmented_cost(cost, row_mask, col_mask, thresh):
    """(P, R, C+R): invalid or NaN real pairs at BIG, valid row i's dummy
    column C+i at thresh, an invalid row's at 0, the rest at BIG."""
    P, R, C = cost.shape
    cost = auction.condition_cost(cost)
    big = torch.full_like(cost, BIG)
    pair_ok = row_mask[:, :, None] & col_mask[:, None, :]
    real = torch.where(pair_ok, cost, big)
    eye = torch.eye(R, dtype=torch.bool, device=cost.device)
    dummy_cost = torch.where(row_mask, thresh[:, None], 0.0)
    dummy = torch.where(eye, dummy_cost[:, :, None],
                        torch.full((P, R, R), BIG, device=cost.device))
    return torch.cat([real, dummy], dim=2)


def _lsap_rectangular(aug, rows):
    """Exact shortest-augmenting-path JV on (P, R, NC), R <= NC, for the
    rows listed in ``rows`` (in order); returns (P, R) row2col, -1 for
    rows not listed.

    A row that is invalid in every problem may be left out: its search
    ends at once on its own dummy at reduced cost 0, changes no dual
    variable, and no other search reaches that dummy, whose cost is BIG.
    """
    P, R, NC = aug.shape
    dev = aug.device
    ar = torch.arange(P, device=dev)
    row_ids = torch.arange(R, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    u = torch.zeros((P, R), device=dev)
    v = torch.zeros((P, NC), device=dev)
    row2col = torch.full((P, R), -1, dtype=torch.long, device=dev)
    col2row = torch.full((P, NC), -1, dtype=torch.long, device=dev)

    for cur in rows:
        # --- Dijkstra over columns from row `cur` ---------------------
        d = torch.full((P, NC), float("inf"), device=dev)
        pred = torch.zeros((P, NC), dtype=torch.long, device=dev)
        SC = torch.zeros((P, NC), dtype=torch.bool, device=dev)
        SR = torch.zeros((P, R), dtype=torch.bool, device=dev)
        SR[:, cur] = True
        i = torch.full((P,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros((P,), device=dev)
        found = torch.zeros((P,), dtype=torch.bool, device=dev)
        while not bool(found.all()):
            act = ~found
            r = ((min_val[:, None] + aug[ar, i]) - u[ar, i][:, None]) - v
            upd = act[:, None] & ~SC & (r < d)
            d = torch.where(upd, r, d)
            pred = torch.where(upd, i[:, None], pred)
            dm = torch.where(SC, inf, d)
            j = dm.argmin(dim=1)
            mv = dm[ar, j]
            SC[ar, j] |= act
            owner = col2row[ar, j]
            hit = owner < 0
            i_next = torch.where(hit, i, owner)
            SR[ar, i_next.clamp_min(0)] |= act
            min_val = torch.where(act, mv, min_val)
            i = torch.where(act, i_next, i)
            found = found | hit

        # the sink is the one visited column without an owner
        sink = (SC & (col2row < 0)).to(torch.uint8).argmax(dim=1)

        # --- dual updates (classical JV, as scipy's lsap) -------------
        u[:, cur] += min_val
        d_assigned = d.gather(1, row2col.clamp(0, NC - 1))
        u = u + torch.where(SR & (row_ids != cur),
                            min_val[:, None] - d_assigned, zero)
        v = v + torch.where(SC, d - min_val[:, None], zero)

        # --- augment along the predecessor path -----------------------
        j = sink
        done = torch.zeros((P,), dtype=torch.bool, device=dev)
        while not bool(done.all()):
            act = ~done
            i = pred[ar, j]
            col2row[ar, j] = torch.where(act, i, col2row[ar, j])
            j_next = row2col[ar, i]
            row2col[ar, i] = torch.where(act, j, row2col[ar, i])
            done = done | (i == cur)
            j = torch.where(act, j_next.clamp_min(0), j)
    return row2col


def solve_lap_masked(cost: torch.Tensor, row_mask: torch.Tensor,
                     col_mask: torch.Tensor, thresh, impl: str = "jv"):
    """Masked assignment with cost limit for P problems.

    Args:
        cost: (P, R, C) costs, lower is better; NaN costs are never
            matched and +-inf are clipped to +-1e6, as in the JAX solvers.
        row_mask: (P, R) bool, valid rows.
        col_mask: (P, C) bool, valid columns.
        thresh: cost limit, a float or a (P,) tensor; a pair is matched
            only if its cost is below it (reference semantics:
            lap_solver.hpp:296-320).
        impl: "jv", "auction" or "auction_pallas" (see the module doc).

    Returns:
        row2col (P, R) int32, matched column per row or -1, and
        col2row (P, C) int32, matched row per column or -1.
    """
    P, R, C = cost.shape
    cost = cost.to(torch.float32).contiguous()
    if isinstance(thresh, torch.Tensor):
        thresh = thresh.to(cost.device, torch.float32).expand(P).contiguous()
    else:  # a fill on the device, not a copy from the host
        thresh = torch.full((P,), float(thresh), device=cost.device)
    row_mask = row_mask.contiguous()
    col_mask = col_mask.contiguous()
    if impl == "auction_pallas":
        return auction_cuda.solve(cost, row_mask, col_mask, thresh)
    if impl == "auction":
        return auction.solve_lap_auction(cost, row_mask, col_mask, thresh)
    if impl != "jv":
        raise ValueError(f"unknown LAP impl {impl!r}")
    aug = _augmented_cost(cost, row_mask, col_mask, thresh)
    rows = torch.nonzero(row_mask.any(dim=0)).flatten().tolist()
    r2c = _lsap_rectangular(aug, rows)
    row2col = torch.where((r2c < C) & row_mask, r2c, -1)
    # unmatched rows scatter to the extra column C, which is dropped
    col2row = torch.full((P, C + 1), -1, dtype=torch.long, device=cost.device)
    col2row.scatter_(1, torch.where(row2col >= 0, row2col, C),
                     torch.arange(R, device=cost.device).expand(P, R))
    return row2col.to(torch.int32), col2row[:, :C].to(torch.int32)


def solve_lap(cost: torch.Tensor, thresh):
    """Unmasked convenience wrapper over :func:`solve_lap_masked` (exact
    JV) for ``(..., R, C)`` costs (one (R, C) problem, as the JAX
    package's ``solve_lap``, or a batch); returns ``(..., R)`` and
    ``(..., C)``."""
    *lead, R, C = cost.shape
    P = math.prod(lead)
    ones = torch.ones((P, R + C), dtype=torch.bool, device=cost.device)
    r2c, c2r = solve_lap_masked(cost.reshape(P, R, C), ones[:, :R],
                                ones[:, R:], thresh)
    return r2c.reshape(*lead, R), c2r.reshape(*lead, C)
