"""SORT / OC-SORT Kalman filter in [x, y, s, r] space, batched.

Counterpart of ``motcpp_tpu/ops/kalman/xysr.py`` (reference:
src/motion/kalman_filters/xysr_kf.cpp:10-143). State [x, y, s, r, vx,
vy, vs] (7D; the aspect ratio r has no velocity), measurement [x, y, s,
r]. Every function takes any leading batch dimensions (streams, track
slots) and keeps the JAX package's order of operations: F P F' as three
slice adds, the gain from the closed-form SPD solve, the Joseph terms as
unrolled rank-1 products, and a final symmetrisation.
"""

from __future__ import annotations

import dataclasses

import torch

from motcpp_tpu_torch.ops.linalg import matmul_small, solve_spd

DIM_X = 7
DIM_Z = 4


@dataclasses.dataclass(frozen=True)
class XYSRParams:
    """Noise configuration (reference: xysr_kf.cpp:49-68).

    q_xy_scaling / q_s_scaling multiply the base velocity process noise
    0.01 / 0.0001: SORT keeps them at 1, OC-SORT passes 0.01 / 0.0001
    (reference: src/trackers/ocsort.cpp:76-79).
    """

    q_xy_scaling: float = 1.0
    q_s_scaling: float = 1.0

    def Q_diag(self, device=None) -> torch.Tensor:
        qxy = 0.01 * self.q_xy_scaling
        qs = 0.0001 * self.q_s_scaling
        return torch.tensor([1.0, 1.0, 1.0, 1.0, qxy, qxy, qs],
                            dtype=torch.float32, device=device)

    def R_diag(self, device=None) -> torch.Tensor:
        # R = I with the scale and ratio rows x10 (xysr_kf.cpp:64-65)
        return torch.tensor([1.0, 1.0, 10.0, 10.0], dtype=torch.float32,
                            device=device)

    def P0(self, device=None) -> torch.Tensor:
        # P = 10 I, velocity block x100 (xysr_kf.cpp:52-55)
        return torch.diag(torch.tensor(
            [10.0, 10.0, 10.0, 10.0, 1000.0, 1000.0, 1000.0],
            dtype=torch.float32, device=device))


def xysr_init(xysr: torch.Tensor, params: XYSRParams | None = None):
    """New-track state: x = [measurement, 0, 0, 0], P = P0
    (reference: src/trackers/sort.cpp:30-41)."""
    params = params or XYSRParams()
    zeros = xysr.new_zeros(xysr.shape[:-1] + (DIM_X - DIM_Z,))
    x = torch.cat([xysr, zeros], dim=-1)
    P = params.P0(xysr.device).expand(xysr.shape[:-1] + (DIM_X, DIM_X))
    return x, P


def xysr_predict(x: torch.Tensor, P: torch.Tensor,
                 params: XYSRParams | None = None):
    """x <- F x; P <- F P F' + Q (reference: xysr_kf.cpp:71-77), with
    F = I + U, U the shift (0..2) += (4..6):
    F P F' = P + U P + P U' + U P U' as three slice adds."""
    params = params or XYSRParams()
    new_x = x.clone()
    new_x[..., 0:3] += x[..., 4:7]
    new_P = P.clone()
    new_P[..., :3, :] += P[..., 4:7, :]
    new_P[..., :, :3] += P[..., :, 4:7]
    new_P[..., :3, :3] += P[..., 4:7, 4:7]
    new_P.diagonal(dim1=-2, dim2=-1).add_(params.Q_diag(x.device))
    return new_x, new_P


def xysr_update(x: torch.Tensor, P: torch.Tensor, z: torch.Tensor,
                params: XYSRParams | None = None):
    """Joseph-form Kalman correction (reference: xysr_kf.cpp:79-112):
    S = P[:4,:4] + R; K = P[:, :4] S^-1; x += K y;
    P <- P - M - M' + K P[:4,:4] K' + K R K' with M = K P[:4, :]."""
    params = params or XYSRParams()
    R = params.R_diag(x.device)
    y = z - x[..., :DIM_Z]
    S = P[..., :DIM_Z, :DIM_Z] + torch.diag(R)
    PHt = P[..., :, :DIM_Z]  # (..., 7, 4)
    K = solve_spd(S, PHt.transpose(-1, -2)).transpose(-1, -2)
    prod = K * y[..., None, :]
    corr = prod[..., 0]
    for i in range(1, DIM_Z):
        corr = corr + prod[..., i]
    new_x = x + corr
    M = matmul_small(K, P[..., :DIM_Z, :])
    Kt = K.transpose(-1, -2)
    KP44Kt = matmul_small(matmul_small(K, P[..., :DIM_Z, :DIM_Z]), Kt)
    KRKt = matmul_small(K * R, Kt)
    new_P = P - M - M.transpose(-1, -2) + KP44Kt + KRKt
    # exact symmetry (float32 orderings drift over long sequences)
    new_P = 0.5 * (new_P + new_P.transpose(-1, -2))
    return new_x, new_P


def _rot(m, block):
    """m block m' for (..., 2, 2) m, in the order of the JAX einsum
    "...ij,...jk,...lk->...il" evaluated as (m block) m'."""
    return torch.matmul(torch.matmul(m, block), m.transpose(-1, -2))


def xysr_apply_affine(x: torch.Tensor, P: torch.Tensor, m: torch.Tensor,
                      t: torch.Tensor):
    """Camera-motion correction of position, velocity and their
    covariance blocks (reference: xysr_kf.cpp:114-141).
    m: (..., 2, 2) linear part, t: (..., 2) translation."""
    pos = torch.matmul(m, x[..., 0:2, None])[..., 0] + t
    vel = torch.matmul(m, x[..., 4:6, None])[..., 0]
    new_x = x.clone()
    new_x[..., 0:2] = pos
    new_x[..., 4:6] = vel
    P = P.clone()
    P[..., 0:2, 0:2] = _rot(m, P[..., 0:2, 0:2])
    P[..., 4:6, 4:6] = _rot(m, P[..., 4:6, 4:6])
    pv = _rot(m, P[..., 0:2, 4:6])
    P[..., 0:2, 4:6] = pv
    P[..., 4:6, 0:2] = pv.transpose(-1, -2)
    return new_x, P
