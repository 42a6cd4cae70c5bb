"""IoU distance and score fusion for the association costs.

Counterpart of ``motcpp_tpu/ops/matching.py::iou_distance`` and
``fuse_score``, batched over any leading dimensions.
"""

from __future__ import annotations

import torch

from motcpp_tpu_torch.ops.iou import iou_batch


def iou_distance(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """1 - IoU (reference: src/utils/matching.cpp:62-65)."""
    return 1.0 - iou_batch(a_xyxy, b_xyxy)


def fuse_score(iou_cost: torch.Tensor, det_confs: torch.Tensor) -> torch.Tensor:
    """1 - (1 - iou_cost) * conf for ``(..., K, N)`` costs and ``(..., N)``
    confidences (reference: src/utils/matching.cpp:130-143)."""
    return 1.0 - (1.0 - iou_cost) * det_confs[..., None, :]
