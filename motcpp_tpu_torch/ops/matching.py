"""Cost fusion, embedding distances and the assignment wrappers.

Counterpart of ``motcpp_tpu/ops/matching.py`` (reference:
include/motcpp/utils/matching.hpp, src/utils/matching.cpp). The cost
functions are batched over any leading dimensions; the masked
assignment returns index maps instead of dynamic lists, and
:func:`linear_assignment` is the host wrapper with the reference's
return shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.iou import iou_batch
from motcpp_tpu_torch.ops.lap import solve_lap_masked

# Chi-square 0.95 quantiles, 1..9 dof (reference: utils/matching.hpp:16-26)
CHI2INV95 = (
    3.8415,
    5.9915,
    7.8147,
    9.4877,
    11.070,
    12.592,
    14.067,
    15.507,
    16.919,
)


def iou_distance(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """1 - IoU (reference: src/utils/matching.cpp:62-65)."""
    return 1.0 - iou_batch(a_xyxy, b_xyxy)


def embedding_distance(track_feats: torch.Tensor, det_feats: torch.Tensor,
                       metric: str = "cosine") -> torch.Tensor:
    """Pairwise embedding distance of ``(..., K, D)`` and ``(..., N, D)``
    features (reference: src/utils/matching.cpp:67-107).

    cosine: max(0, 1 - cos_sim) with the reference's +1e-10 denominator
    guard; euclidean: plain L2.
    """
    prod = track_feats @ det_feats.transpose(-1, -2)
    if metric == "cosine":
        tn = torch.linalg.vector_norm(track_feats, dim=-1, keepdim=True)
        dn = torch.linalg.vector_norm(det_feats, dim=-1, keepdim=True)
        sim = prod / (tn * dn.transpose(-1, -2) + 1e-10)
        return torch.clamp_min(1.0 - sim, 0.0)
    if metric == "euclidean":
        d2 = ((track_feats ** 2).sum(-1)[..., :, None] - 2.0 * prod
              + (det_feats ** 2).sum(-1)[..., None, :])
        return torch.sqrt(torch.clamp_min(d2, 0.0))
    raise ValueError(f"Unknown metric: {metric}")


def fuse_score(iou_cost: torch.Tensor, det_confs: torch.Tensor) -> torch.Tensor:
    """1 - (1 - iou_cost) * conf for ``(..., K, N)`` costs and ``(..., N)``
    confidences (reference: src/utils/matching.cpp:130-143)."""
    return 1.0 - (1.0 - iou_cost) * det_confs[..., None, :]


def fuse_iou(reid_cost: torch.Tensor, tracks_xyxy: torch.Tensor,
             dets_xyxy: torch.Tensor) -> torch.Tensor:
    """reid_sim * (1 + iou_sim) / 2 -> cost (reference:
    src/utils/matching.cpp:109-128)."""
    reid_sim = 1.0 - reid_cost
    iou_sim = iou_batch(tracks_xyxy, dets_xyxy)
    return 1.0 - reid_sim * (1.0 + iou_sim) / 2.0


def fuse_motion(cost: torch.Tensor, gating_dist: torch.Tensor,
                only_position: bool = False, lam: float = 0.98) -> torch.Tensor:
    """Mahalanobis gating + lambda blend (reference:
    utils/matching.hpp:61-94). ``gating_dist`` is the precomputed squared
    Mahalanobis matrix from the Kalman filter; entries above
    chi2inv95[dof] are gated to +inf, the rest blended
    ``lam * cost + (1 - lam) * maha``."""
    gate = CHI2INV95[(2 if only_position else 4) - 1]
    blended = lam * cost + (1.0 - lam) * gating_dist
    return torch.where(gating_dist > gate, torch.inf, blended)


def linear_assignment_masked(cost: torch.Tensor, row_mask: torch.Tensor,
                             col_mask: torch.Tensor, thresh):
    """Masked assignment with cost-limit semantics (reference:
    src/utils/matching.cpp:14-60) over ``(..., R, C)`` costs with
    ``(..., R)`` and ``(..., C)`` masks, on the costs' device, by the
    exact JV of :func:`motcpp_tpu_torch.ops.lap.solve_lap_masked`.

    Returns ``(row2col, col2row)`` int32 maps with -1 for unmatched.
    """
    *lead, R, C = cost.shape
    P = math.prod(lead)
    r2c, c2r = solve_lap_masked(cost.reshape(P, R, C),
                                row_mask.reshape(P, R),
                                col_mask.reshape(P, C), thresh)
    return r2c.reshape(*lead, R), c2r.reshape(*lead, C)


def linear_assignment(cost: np.ndarray, thresh: float, device="cuda"):
    """Host wrapper with the reference's return shape: ``(matches [(i,
    j)], unmatched_a, unmatched_b)`` for an (n, m) numpy cost, solved on
    ``device`` (default ``"cuda"``; raises without one)."""
    dev = resolve_device(device)
    cost = np.asarray(cost, np.float32)
    n, m = cost.shape
    if n == 0 or m == 0:
        return [], list(range(n)), list(range(m))
    r2c, c2r = linear_assignment_masked(
        torch.from_numpy(cost).to(dev),
        torch.ones((n,), dtype=torch.bool, device=dev),
        torch.ones((m,), dtype=torch.bool, device=dev), thresh)
    r2c, c2r = r2c.cpu().numpy(), c2r.cpu().numpy()
    matches = [(i, int(r2c[i])) for i in range(n) if r2c[i] >= 0]
    unmatched_a = [i for i in range(n) if r2c[i] < 0]
    unmatched_b = [j for j in range(m) if c2r[j] < 0]
    return matches, unmatched_a, unmatched_b
