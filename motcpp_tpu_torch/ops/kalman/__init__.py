"""Batched Kalman filters over fixed-capacity track slots."""

from motcpp_tpu_torch.ops.kalman.gaussian import GaussianKF, kf_xyah, kf_xywh

__all__ = ["GaussianKF", "kf_xyah", "kf_xywh"]
