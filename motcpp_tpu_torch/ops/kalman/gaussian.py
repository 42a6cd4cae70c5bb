"""DeepSORT-style Gaussian Kalman filter in XYAH space, batched.

Counterpart of ``motcpp_tpu/ops/kalman/gaussian.py`` (``GaussianKF``,
``kf_xyah`` and ``kf_xywh``). State is [pos(d), vel(d)] with F = [I, I; 0, I] and
H = [I, 0]; the covariance is handled through its four (d, d) blocks,

    F P F' = [[A+B+C+D, B+D], [C+D, D]],   projected cov = A + R,

so predict and update are a few adds and one closed-form (d, d) solve
over every track slot of every stream at once. ``nsa_conf`` gives the
NSA scaling of the measurement noise by detection confidence that
StrongSORT uses; ``gating_distance`` is the Mahalanobis gate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from motcpp_tpu_torch.ops.linalg import matmul_small, solve_spd


@dataclasses.dataclass(frozen=True)
class GaussianKF:
    """Dimension and noise-std hooks. Each hook takes the height column
    ``(...,)`` and returns per-dimension stds ``(..., 2d)`` or ``(..., d)``."""

    ndim: int
    initial_std: Callable
    process_std: Callable
    measurement_std: Callable

    def initiate(self, measurement: torch.Tensor):
        """measurement (..., d) -> mean (..., 2d), cov (..., 2d, 2d), with
        zero velocities (reference: kalman_filter.cpp:29-42)."""
        mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
        std = self.initial_std(measurement[..., 3])
        return mean, torch.diag_embed(std * std)

    def predict(self, mean: torch.Tensor, cov: torch.Tensor):
        """x <- F x, P <- F P F' + Q (reference: kalman_filter.cpp:44-58)."""
        d = self.ndim
        pos, vel = mean[..., :d], mean[..., d:]
        new_mean = torch.cat([pos + vel, vel], dim=-1)

        A = cov[..., :d, :d]
        B = cov[..., :d, d:]
        C = cov[..., d:, :d]
        D = cov[..., d:, d:]
        new_cov = _blocks_to_full(A + B + C + D, B + D, C + D, D)
        std = self.process_std(mean[..., 3])
        new_cov.diagonal(dim1=-2, dim2=-1).add_(std * std)
        return new_mean, new_cov

    def project(self, mean: torch.Tensor, cov: torch.Tensor, nsa_conf=0.0):
        """Mean and covariance in measurement space, with the NSA noise
        scaling R <- ((1 - conf) std)^2 (reference:
        kalman_filter.cpp:60-75). ``nsa_conf`` is a float or a tensor
        of the leading shape; the default 0 leaves R as it is (its
        multiply by 1.0 is exact, so it is skipped)."""
        d = self.ndim
        std = self.measurement_std(mean[..., 3])
        if isinstance(nsa_conf, torch.Tensor) or nsa_conf != 0.0:
            std = std * (1.0 - torch.as_tensor(nsa_conf, dtype=std.dtype,
                                               device=std.device))[..., None]
        return mean[..., :d], cov[..., :d, :d] + torch.diag_embed(std * std)

    def update(self, mean: torch.Tensor, cov: torch.Tensor,
               measurement: torch.Tensor, nsa_conf=0.0):
        """Kalman correction (reference: kalman_filter.cpp:77-112) with
        the gain K = P H' S^-1 from the closed-form SPD solve; ``nsa_conf``
        as in :meth:`project`."""
        d = self.ndim
        proj_mean, S = self.project(mean, cov, nsa_conf)
        PHt = cov[..., :, :d]  # (..., 2d, d) = P H'
        K = solve_spd(S, PHt.transpose(-1, -2)).transpose(-1, -2)
        innovation = measurement - proj_mean
        prod = K * innovation[..., None, :]
        corr = prod[..., 0]
        for i in range(1, d):
            corr = corr + prod[..., i]
        new_mean = mean + corr
        KS = matmul_small(K, S)
        new_cov = cov - matmul_small(KS, K.transpose(-1, -2))
        return new_mean, new_cov

    def gating_distance(self, mean: torch.Tensor, cov: torch.Tensor,
                        measurements: torch.Tensor,
                        only_position: bool = False, nsa_conf=0.0):
        """Squared Mahalanobis distance of measurements (..., M, d) to
        each projected state (..., 2d); returns (..., M) (reference:
        kalman_filter.cpp:148-176). ``only_position`` keeps the first
        two dimensions."""
        proj_mean, S = self.project(mean, cov, nsa_conf)
        diff = measurements - proj_mean[..., None, :]
        if only_position:
            diff = diff[..., :2]
            S = S[..., :2, :2]
        prod = solve_spd(S, diff.transpose(-1, -2)).transpose(-1, -2) * diff
        dist = prod[..., 0]
        for i in range(1, prod.shape[-1]):
            dist = dist + prod[..., i]
        return dist


def _blocks_to_full(tl, tr, bl, br):
    top = torch.cat([tl, tr], dim=-1)
    bot = torch.cat([bl, br], dim=-1)
    return torch.cat([top, bot], dim=-2)


_WP = 1.0 / 20.0  # std_weight_position (reference: kalman_filter.cpp:13)
_WV = 1.0 / 160.0  # std_weight_velocity (reference: kalman_filter.cpp:14)


def _xyah_initial_std(h):
    """reference: xyah_kf.cpp:14-29."""
    z = torch.zeros_like(h)
    return torch.stack(
        [2 * _WP * h, 2 * _WP * h, z + 1e-2, 2 * _WP * h,
         10 * _WV * h, 10 * _WV * h, z + 1e-5, 10 * _WV * h],
        dim=-1,
    )


def _xyah_process_std(h):
    """reference: xyah_kf.cpp:31-48."""
    z = torch.zeros_like(h)
    return torch.stack(
        [_WP * h, _WP * h, z + 1e-2, _WP * h,
         _WV * h, _WV * h, z + 1e-5, _WV * h],
        dim=-1,
    )


def _xyah_measurement_std(h):
    """reference: xyah_kf.cpp:50-62."""
    z = torch.zeros_like(h)
    return torch.stack([_WP * h, _WP * h, z + 1e-1, _WP * h], dim=-1)


kf_xyah = GaussianKF(
    ndim=4,
    initial_std=_xyah_initial_std,
    process_std=_xyah_process_std,
    measurement_std=_xyah_measurement_std,
)
"""ByteTrack filter (reference: xyah_kf.{hpp,cpp})."""


def _xywh_initial_std(h):
    """reference: xywh_kf.hpp:48-58, all four dims height-scaled."""
    p = 2 * _WP * h
    v = 10 * _WV * h
    return torch.stack([p, p, p, p, v, v, v, v], dim=-1)


def _xywh_process_std(h):
    """reference: xywh_kf.hpp:77-87."""
    p = _WP * h
    v = _WV * h
    return torch.stack([p, p, p, p, v, v, v, v], dim=-1)


def _xywh_measurement_std(h):
    """reference: xywh_kf.hpp:110-116."""
    p = _WP * h
    return torch.stack([p, p, p, p], dim=-1)


kf_xywh = GaussianKF(
    ndim=4,
    initial_std=_xywh_initial_std,
    process_std=_xywh_process_std,
    measurement_std=_xywh_measurement_std,
)
"""BoT-SORT filter (reference: xywh_kf.hpp:17-180): measurement noise
from the predicted mean's height, no NSA scaling."""
