"""Pairwise IoU as an ``(..., N, M)`` broadcast.

Counterpart of ``motcpp_tpu/ops/iou.py::iou_batch``. Padded rows and
columns give values that the callers' masks ignore.
"""

from __future__ import annotations

import torch


def _areas(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def iou_batch(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes ``(..., N, 4)`` x ``(..., M, 4)``;
    union <= 0 gives 0 (reference: utils/iou.hpp:63-99)."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    xx1 = torch.maximum(a[..., 0], b[..., 0])
    yy1 = torch.maximum(a[..., 1], b[..., 1])
    xx2 = torch.minimum(a[..., 2], b[..., 2])
    yy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (xx2 - xx1).clamp_min(0.0) * (yy2 - yy1).clamp_min(0.0)
    union = _areas(b1)[..., :, None] + _areas(b2)[..., None, :] - inter
    ok = union > 0.0
    return torch.where(ok, inter / torch.where(ok, union, torch.ones_like(union)),
                       torch.zeros_like(inter))
