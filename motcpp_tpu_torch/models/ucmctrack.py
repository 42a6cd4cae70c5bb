"""UCMCTrack: ground-plane Mahalanobis tracking, batched over streams.

Counterpart of ``motcpp_tpu/models/ucmctrack.py``; its module doc lists
the reference behaviours this step replicates (reference:
src/trackers/ucmc.cpp:16-574). Every tensor of the state has a leading
stream dimension S, and one call of the step advances all S streams by
one frame:

  * detections are mapped to ground-plane measurements with their
    Jacobian-propagated noise through the calibration (Ki, Ko), or to a
    0.01-scaled image plane without one (ucmc.cpp:85-140);
  * one constant-velocity predict of every occupied slot;
  * one (S, K, N) cost, Mahalanobis plus ln|S|, for all three stages;
  * stage 1 (confirmed and coasted tracks x high dets at ``a1``) over S
    problems, then stages 2 (the leftovers x low dets at ``a2``) and 3
    (tentative tracks x the leftover high dets at ``a1``) as one
    assignment over 2S problems;
  * one merged Joseph-form update, births of the leftover high dets,
    deaths, and the output of the confirmed tracks matched this frame,
    which emits the raw detection box.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from motcpp_tpu_torch.device import PerDevice, resolve_device
from motcpp_tpu_torch.models import register
from motcpp_tpu_torch.models.base import BaseTrackerWrapper
from motcpp_tpu_torch.ops.lap import solve_lap_masked
from motcpp_tpu_torch.ops.linalg import inv2, matmul_small
from motcpp_tpu_torch.ops.select import birth_slots, gather_rows

FREE = 0
TENTATIVE = 1
CONFIRMED = 2
COASTED = 3


@dataclasses.dataclass(frozen=True)
class UCMCConfig:
    """Reference defaults (ucmc.hpp ctor; eval motcpp_eval.cpp:112-147)."""

    det_thresh: float = 0.3
    max_age: int = 30
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    a1: float = 100.0
    a2: float = 100.0
    wx: float = 5.0
    wy: float = 5.0
    vmax: float = 10.0
    dt: float = 1.0 / 30.0
    high_score: float = 0.5
    Ki: tuple = ()  # 12 values (3x4 row-major) or empty
    Ko: tuple = ()  # 16 values (4x4 row-major) or empty
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"

    def inv_A(self):
        """InvA (3, 3) float32 from Ki*Ko without the z column, inverted
        in float64 (ucmc.cpp:57-82), or None for the image-plane
        fallback."""
        if len(self.Ki) != 12 or len(self.Ko) != 16:
            return None
        Ki = np.asarray(self.Ki, np.float64).reshape(3, 4)
        Ko = np.asarray(self.Ko, np.float64).reshape(4, 4)
        KiKo = Ki @ Ko
        A = np.zeros((3, 3))
        A[:, :2] = KiKo[:, :2]
        A[:, 2] = KiKo[:, 3]
        return np.linalg.inv(A).astype(np.float32)


class UCMCState(NamedTuple):
    x: torch.Tensor  # (S, K, 4) [x, vx, y, vy]
    P: torch.Tensor  # (S, K, 4, 4)
    ustate: torch.Tensor  # (S, K) int32: FREE, TENTATIVE, CONFIRMED, COASTED
    tid: torch.Tensor  # (S, K) int32
    death: torch.Tensor  # (S, K) int32
    birth: torch.Tensor  # (S, K) int32
    det_idx: torch.Tensor  # (S, K) int32, this frame's det or -1
    out_conf: torch.Tensor  # (S, K) float32
    out_cls: torch.Tensor  # (S, K) float32
    out_box: torch.Tensor  # (S, K, 4) box of this frame's detection
    next_id: torch.Tensor  # (S,) int32
    frame_count: torch.Tensor  # (S,) int32


_STATE_DTYPES = {
    "x": torch.float32, "P": torch.float32, "ustate": torch.int32,
    "tid": torch.int32, "death": torch.int32, "birth": torch.int32,
    "det_idx": torch.int32, "out_conf": torch.float32,
    "out_cls": torch.float32, "out_box": torch.float32,
    "next_id": torch.int32, "frame_count": torch.int32,
}


def state_from_numpy(arrays: dict, device="cuda") -> UCMCState:
    """UCMCState from a dict of arrays named as its fields, each with a
    leading stream dimension (for example a JAX state taken mid-scene
    and converted with ``np.asarray``)."""
    dev = resolve_device(device)
    return UCMCState(**{
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)
        for name, dtype in _STATE_DTYPES.items()
    })


def state_to_numpy(state: UCMCState) -> dict:
    """Inverse of :func:`state_from_numpy`."""
    return {name: t.cpu().numpy() for name, t in state._asdict().items()}


def _map_dets(cfg: UCMCConfig, det_xyxy, inv_a=None):
    """Measurements y (..., N, 2) and their noise R (..., N, 2, 2) of
    boxes (..., N, 4) (ucmc.cpp:85-140); ``inv_a`` is ``cfg.inv_A()`` as
    a tensor on the boxes' device, None for the image-plane fallback."""
    x1, y1, x2, y2 = det_xyxy.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    cx = (x1 + x2) * 0.5
    bottom = y2
    if inv_a is None:
        zero = torch.zeros_like(w)
        scale = 0.01
        y = torch.stack([cx * scale, bottom * scale], -1)
        ex = torch.clamp(0.0005 * w, 0.02, 0.13)
        ey = torch.clamp(0.0005 * h, 0.02, 0.10)
        R = torch.stack([torch.stack([ex * ex, zero], -1),
                         torch.stack([zero, ey * ey], -1)], -2)
        return y, R
    A = inv_a
    uv1 = torch.stack([cx, bottom, torch.ones_like(cx)], -1)  # (..., N, 3)
    b = uv1 @ A.T
    gamma = 1.0 / b[..., 2]
    xy = b[..., :2] * gamma[..., None]
    # Jacobian C = gamma*InvA[:2,:2] - gamma^2 * b[:2] InvA[2,:2]
    C = (gamma[..., None, None] * A[:2, :2]
         - (gamma * gamma)[..., None, None] * b[..., :2, None] * A[2:3, :2])
    eu = torch.clamp(0.05 * w, 2.0, 13.0)
    ev = torch.clamp(0.05 * h, 2.0, 10.0)
    # C diag(eu^2, ev^2) C^T, unrolled (a batched product of 2x2
    # matrices is a poor fit for the GPU's matrix units)
    sig = torch.stack([eu * eu, ev * ev], -1)
    R = matmul_small(C * sig[..., None, :], C.transpose(-1, -2))
    return xy, R


def _pos(x):
    """The position [x, y] of a [x, vx, y, vy] state (..., 4)."""
    return x[..., 0::2]


def _hph(P):
    """The position block (..., 2, 2) of P (..., 4, 4)."""
    return P[..., 0::2, 0::2]


def make_ucmctrack(cfg: UCMCConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> UCMCState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N), embs=None) ->
    (state, (out (S, K, 8), out_mask (S, K)))``; ``embs`` is ignored
    (ucmc.cpp:265-266)."""
    K = cfg.max_tracks
    dt = cfg.dt
    dev = resolve_device(device)
    # F, Q and P0 (ucmc.cpp:160-189)
    F = torch.eye(4, device=dev)
    F[0, 1] = dt
    F[2, 3] = dt
    G = torch.tensor([[0.5 * dt * dt, 0.0], [dt, 0.0], [0.0, 0.5 * dt * dt],
                      [0.0, dt]], dtype=torch.float32, device=dev)
    Q = G @ torch.diag(torch.tensor([cfg.wx, cfg.wy], device=dev)) @ G.T
    P0 = torch.diag(torch.tensor([1.0, cfg.vmax ** 2 / 3.0, 1.0,
                                  cfg.vmax ** 2 / 3.0], device=dev))
    inv_a = cfg.inv_A()
    if inv_a is not None:
        inv_a = torch.from_numpy(inv_a).to(dev)
    # the step's constants on the device of its inputs
    consts = PerDevice(lambda d: (F.to(d), Q.to(d), P0.to(d),
                                  torch.eye(4, device=d),
                                  None if inv_a is None else inv_a.to(d)),
                       dev)

    def _dist(x, P, y, R):
        """(S, K, N) Mahalanobis + ln|S| of every track-det pair
        (ucmc.cpp:202-212), the quadratic form unrolled: as a batched
        matrix product over S*K*N pairs of 2-vectors it would run as
        millions of tiny products."""
        Sm = _hph(P)[:, :, None] + R[:, None]  # (S, K, N, 2, 2)
        Sinv, det = inv2(Sm)
        diff = y[:, None, :, :] - _pos(x)[:, :, None, :]  # (S, K, N, 2)
        d0, d1 = diff[..., 0], diff[..., 1]
        maha = (d0 * (Sinv[..., 0, 0] * d0 + Sinv[..., 0, 1] * d1)
                + d1 * (Sinv[..., 1, 0] * d0 + Sinv[..., 1, 1] * d1))
        return maha + torch.log(torch.clamp_min(det, 1e-30))

    def _kf_update(x, P, y, R, eye4):
        """Joseph-form update of (S, K) tracks with one measurement
        each."""
        Sinv, _ = inv2(_hph(P) + R)
        Kg = matmul_small(P[..., :, 0::2], Sinv)  # (S, K, 4, 2)
        innov = y - _pos(x)
        new_x = x + (Kg * innov[..., None, :]).sum(-1)
        KH = torch.zeros_like(P)
        KH[..., :, 0] = Kg[..., :, 0]
        KH[..., :, 2] = Kg[..., :, 1]
        IKH = eye4 - KH
        new_P = matmul_small(matmul_small(IKH, P), IKH.transpose(-1, -2))
        new_P = new_P + matmul_small(matmul_small(Kg, R),
                                     Kg.transpose(-1, -2))
        new_P = 0.5 * (new_P + new_P.transpose(-1, -2))
        return new_x, new_P

    def init_fn(n_streams: int = 1) -> UCMCState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        return UCMCState(
            x=zeros(K, 4, dtype=torch.float32),
            P=P0.expand(S, K, 4, 4).clone(),
            ustate=zeros(K),
            tid=zeros(K),
            death=zeros(K),
            birth=zeros(K),
            det_idx=torch.full((S, K), -1, dtype=torch.int32, device=dev),
            out_conf=zeros(K, dtype=torch.float32),
            out_cls=zeros(K, dtype=torch.float32),
            out_box=zeros(K, 4, dtype=torch.float32),
            next_id=zeros(),
            frame_count=zeros(),
        )

    def step_fn(state: UCMCState, dets, det_mask, embs=None):
        S, N, _ = dets.shape
        F, Q, P0, eye4, inv_a = consts.on(dets.device)
        frame = state.frame_count + 1
        det_conf = dets[..., 4]
        det_xyxy = dets[..., :4]

        valid = det_mask & (det_conf >= cfg.det_thresh)
        high = valid & (det_conf >= cfg.high_score)
        low = valid & (det_conf < cfg.high_score)

        y, Rm = _map_dets(cfg, det_xyxy, inv_a)

        # predict every occupied slot (ucmc.cpp:356-360)
        occupied = state.ustate != FREE
        px = state.x @ F.T
        pP = matmul_small(matmul_small(F, state.P), F.T) + Q
        x = torch.where(occupied[..., None], px, state.x)
        P = torch.where(occupied[..., None, None], pP, state.P)
        ustate, death, birth = state.ustate, state.death, state.birth
        det_idx = torch.full_like(state.det_idx, -1)
        out_conf, out_cls = state.out_conf, state.out_cls
        out_box = state.out_box

        conf_coast = (ustate == CONFIRMED) | (ustate == COASTED)

        # one cost for all three stages: each stage's rows are untouched
        # by the earlier stages' updates, as in the JAX package
        base_cost = _dist(x, P, y, Rm)

        # ---- stage 1: confirmed + coasted x high @ a1 ------------------
        cost1 = torch.where(conf_coast[..., None] & high[:, None, :],
                            base_cost, 1e9)
        r2c1, c2r1 = solve_lap_masked(cost1, conf_coast, high, cfg.a1,
                                      impl=cfg.lap_impl)
        m1 = r2c1 >= 0

        # ---- stages 2+3 over 2S problems: leftovers x low @ a2,
        #      tentative x leftover high @ a1 -----------------------------
        remain = conf_coast & ~m1
        tent = ustate == TENTATIVE
        rem_high = high & (c2r1 < 0)
        rows = torch.cat([remain, tent])
        cols = torch.cat([low, rem_high])
        cost23 = torch.where(rows[..., None] & cols[:, None, :],
                             base_cost.repeat(2, 1, 1), 1e9)
        th23 = torch.cat([torch.full((S,), cfg.a2, device=dets.device),
                          torch.full((S,), cfg.a1, device=dets.device)])
        r2c23, c2r23 = solve_lap_masked(cost23, rows, cols, th23,
                                        impl=cfg.lap_impl)
        r2c2, r2c3, c2r3 = r2c23[:S], r2c23[S:], c2r23[S:]
        m2 = r2c2 >= 0
        m3 = r2c3 >= 0

        # ---- merged commit ---------------------------------------------
        m12 = m1 | m2
        m123 = m12 | m3
        j123 = torch.where(m1, r2c1, torch.where(m2, r2c2, r2c3)).clamp(
            0, N - 1)
        drow = gather_rows(dets, j123)
        ux, uP = _kf_update(x, P, gather_rows(y, j123),
                            gather_rows(Rm.reshape(S, N, 4), j123)
                            .reshape(S, K, 2, 2), eye4)
        x = torch.where(m123[..., None], ux, x)
        P = torch.where(m123[..., None, None], uP, P)
        death = torch.where(m123, 0, death)
        det_idx = torch.where(m123, j123, det_idx)
        out_conf = torch.where(m123, drow[..., 4], out_conf)
        out_cls = torch.where(m123, drow[..., 5], out_cls)
        out_box = torch.where(m123[..., None], drow[..., :4], out_box)
        ustate = torch.where(m12, CONFIRMED, ustate)
        ustate = torch.where(remain & ~m2, COASTED, ustate)
        birth = torch.where(m3, birth + 1, birth)
        promote = m3 & (birth >= 2)
        ustate = torch.where(promote, CONFIRMED, ustate)
        birth = torch.where(promote, 0, birth)

        # ---- births: leftover high dets -> tentative -------------------
        u_det = rem_high & (c2r3 < 0)
        free = ustate == FREE
        births, bdet, slot_rank = birth_slots(free, u_det)
        by = gather_rows(y, bdet)
        brow = gather_rows(dets, bdet)
        zero = torch.zeros_like(by[..., 0])
        bx = torch.stack([by[..., 0], zero, by[..., 1], zero], -1)
        x = torch.where(births[..., None], bx, x)
        P = torch.where(births[..., None, None], P0, P)
        ustate = torch.where(births, TENTATIVE, ustate)
        death = torch.where(births, 0, death)
        birth = torch.where(births, 0, birth)
        det_idx = torch.where(births, bdet, det_idx)
        out_conf = torch.where(births, brow[..., 4], out_conf)
        out_cls = torch.where(births, brow[..., 5], out_cls)
        out_box = torch.where(births[..., None], brow[..., :4], out_box)
        tid = torch.where(births, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            u_det.sum(1, dtype=torch.int32), free.sum(1, dtype=torch.int32))

        # ---- deaths: every live track's count grows (ucmc.cpp:531-548) -
        death = torch.where(ustate != FREE, death + 1, death)
        kill = (((ustate == COASTED) & (death >= cfg.max_age))
                | ((ustate == TENTATIVE) & (death >= 2)))
        ustate = torch.where(kill, FREE, ustate)

        # ---- output: confirmed and matched this frame (ucmc.cpp:307-331)
        out_mask = (ustate == CONFIRMED) & (det_idx >= 0)
        out = torch.cat(
            [out_box, tid[..., None].to(torch.float32), out_conf[..., None],
             out_cls[..., None], det_idx[..., None].to(torch.float32)],
            dim=-1,
        )
        new_state = UCMCState(
            x=x, P=P, ustate=ustate, tid=tid, death=death, birth=birth,
            det_idx=det_idx, out_conf=out_conf, out_cls=out_cls,
            out_box=out_box, next_id=next_id, frame_count=frame,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("ucmctrack")
@register("ucmc")
class UCMCTrack(BaseTrackerWrapper):
    """Host-facing UCMCTrack (reference: ucmc.hpp ctor defaults; eval
    construction motcpp_eval.cpp:112-147)."""

    def __init__(
        self,
        det_thresh: float = 0.3,
        max_age: int = 30,
        max_obs: int = 50,
        min_hits: int = 3,
        iou_threshold: float = 0.3,
        per_class: bool = False,
        nr_classes: int = 80,
        asso_func: str = "iou",
        is_obb: bool = False,
        a1: float = 100.0,
        a2: float = 100.0,
        wx: float = 5.0,
        wy: float = 5.0,
        vmax: float = 10.0,
        dt: float = 1.0 / 30.0,
        high_score: float = 0.5,
        Ki=(),
        Ko=(),
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, device=device)
        del per_class, nr_classes, asso_func, is_obb
        self.cfg = UCMCConfig(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            a1=a1,
            a2=a2,
            wx=wx,
            wy=wy,
            vmax=vmax,
            dt=dt,
            high_score=high_score,
            Ki=tuple(Ki),
            Ko=tuple(Ko),
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self._init, self._core_step = make_ucmctrack(self.cfg,
                                                     device=self.device)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask)
