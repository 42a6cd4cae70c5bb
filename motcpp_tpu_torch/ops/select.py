"""Per-row selects and slot writes over fixed-capacity track state.

Counterpart of ``motcpp_tpu/ops/select.py``. The JAX package writes
these as one-hot selects, which keep XLA's fusions on the TPU; here they
are gathers and masked writes, which is what the GPU does well. Each
takes any leading dimensions (streams first) and gives the JAX helper's
values exactly: a selected element is read, never summed, and an index
out of range reads the documented fill (``gather_rows`` takes indices in
range only).
"""

from __future__ import annotations

import torch


def take_per_row(mat, idx, *, fill=0.0):
    """``mat[..., i, idx[..., i]]``, ``fill`` where ``idx`` is out of
    range. mat (..., A, B), idx (..., A) int."""
    B = mat.shape[-1]
    val = mat.gather(-1, idx.long().clamp(0, B - 1)[..., None])[..., 0]
    return torch.where((idx >= 0) & (idx < B), val,
                       torch.full_like(val, fill))


def gather_rows(tab, idx):
    """``tab[..., idx[..., k], :]`` -> (..., K, D) for tab (..., N, D) and
    idx (..., K) in [0, N); every caller clips its indices first, as in
    the JAX package (whose helper would give rows of zeros otherwise)."""
    D = tab.shape[-1]
    return tab.gather(-2, idx.long()[..., None].expand(idx.shape + (D,)))


def take_slot(ring, slot):
    """``ring[..., k, slot[..., k], :]`` -> (..., K, D).
    ring (..., K, R, D), slot (..., K) int in range."""
    D = ring.shape[-1]
    return ring.gather(-2, slot.long()[..., None, None]
                       .expand(slot.shape + (1, D)))[..., 0, :]


def _slot_hit(slot, mask, R):
    hit = slot[..., None] == torch.arange(R, device=slot.device)
    return hit & mask[..., None]


def write_slot(ring, slot, new, mask):
    """Where ``mask[..., k]``, ``ring[..., k, slot[..., k], :] =
    new[..., k, :]``. ring (..., K, R, D), new (..., K, D), mask (..., K)."""
    hit = _slot_hit(slot, mask, ring.shape[-2])
    return torch.where(hit[..., None], new[..., None, :], ring)


def write_slot_scalar(ring, slot, new, mask):
    """:func:`write_slot` for a scalar payload: ring (..., K, R),
    new (..., K)."""
    hit = _slot_hit(slot, mask, ring.shape[-1])
    return torch.where(hit, new[..., None], ring)


def invert_matching(d2t, K):
    """A one-to-one det -> track matching (..., N), values in [0, K) or
    -1, as track -> det (..., K) int32, -1 where unmatched."""
    lead, N = d2t.shape[:-1], d2t.shape[-1]
    flat = d2t.reshape(-1, N).long()
    # unmatched dets scatter to the extra column K, which is dropped
    t2d = torch.full((flat.shape[0], K + 1), -1, dtype=torch.int32,
                     device=d2t.device)
    t2d.scatter_(1, torch.where(flat >= 0, flat, K),
                 torch.arange(N, dtype=torch.int32, device=d2t.device)
                 .expand_as(flat))
    return t2d[:, :K].reshape(lead + (K,))


def _rank_match(rows, cols):
    """rank_match, and the rank of each True of ``rows``."""
    lead, K, N = rows.shape[:-1], rows.shape[-1], cols.shape[-1]
    rows2, cols2 = rows.reshape(-1, K), cols.reshape(-1, N)
    col_rank = torch.cumsum(cols2.to(torch.int32), 1, dtype=torch.int32) - 1
    row_rank = torch.cumsum(rows2.to(torch.int32), 1, dtype=torch.int32) - 1
    n_cols = cols2.sum(1, dtype=torch.int32)
    # the column of each rank; ranks >= K (when N > K) and non-candidates
    # land in the extra position K, which is dropped
    by_rank = torch.zeros((cols2.shape[0], K + 1), dtype=torch.int32,
                          device=cols.device)
    rank_pos = torch.where(cols2 & (col_rank < K), col_rank, K).long()
    by_rank.scatter_(1, rank_pos, torch.arange(N, dtype=torch.int32,
                                               device=cols.device)
                     .expand_as(cols2))
    paired = rows2 & (row_rank < n_cols[:, None])
    col = torch.where(paired,
                      by_rank.gather(1, row_rank.clamp(0, K - 1).long()), 0)
    shape = lead + (K,)
    return paired.reshape(shape), col.reshape(shape), row_rank.reshape(shape)


def rank_match(rows, cols):
    """Pair the r-th True of ``rows`` (..., K) with the r-th True of
    ``cols`` (..., N). Returns ``paired`` (..., K) and ``col`` (..., K)
    int32, the paired column's index (0 where unpaired)."""
    return _rank_match(rows, cols)[:2]


def birth_slots(free, cand):
    """Allocate candidate dets (..., N) to free track slots (..., K) in
    detection order, the shared birth pattern of the trackers (reference:
    the per-tracker ``new Track(...)`` loops, e.g. sort.cpp:205-212).
    Returns births (..., K) bool, det_idx (..., K) int32 (0 where none is
    born) and the slot rank (..., K) int32, which issues the ids."""
    return _rank_match(free, cand)


def set_at_col(mat, col, value):
    """``mat[..., a, col[..., a]] = value`` for every row a.
    mat (..., A, B), col (..., A) int in range, value a scalar."""
    hit = col[..., None] == torch.arange(mat.shape[-1], device=mat.device)
    return torch.where(hit, torch.as_tensor(value, dtype=mat.dtype,
                                            device=mat.device), mat)
