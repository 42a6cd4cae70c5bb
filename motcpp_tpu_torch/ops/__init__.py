"""Counterparts of motcpp_tpu.ops: box, cost, Kalman and assignment ops
on tensors with leading batch dimensions."""

from motcpp_tpu_torch.ops import boxes, iou, lap, matching
from motcpp_tpu_torch.ops.lap import solve_lap_masked
from motcpp_tpu_torch.ops.matching import linear_assignment_masked

__all__ = [
    "boxes",
    "iou",
    "lap",
    "matching",
    "solve_lap_masked",
    "linear_assignment_masked",
]
