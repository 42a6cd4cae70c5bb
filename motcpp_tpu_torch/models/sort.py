"""SORT: one IoU assignment a frame over XYSR Kalman slots, batched over
streams.

Counterpart of ``motcpp_tpu/models/sort.py``; its module doc lists the
reference behaviours this step replicates (reference:
src/trackers/sort.cpp:82-255). Every tensor of the state has a leading
stream dimension S, and one call of the step advances all S streams by
one frame: confidence filter, Kalman predict of the active slots, NaN
prune, the (S, K, N) 1 - IoU cost, one assignment over S problems, the
Kalman update of the matched slots, births in detection order, deaths
past ``max_age`` and the output gate.

Oriented boxes (``is_obb``): dets are [cx, cy, w, h, angle, conf, cls],
the cost is the exact rotated IoU (``ops/iou.py::iou_batch_obb``), the
filter tracks (cx, cy, w*h, w/h), the angle is carried in the state and
the output rows are (S, K, 9) [cx, cy, w, h, angle, id, conf, cls,
det_ind], as in the JAX package (which goes beyond the reference there).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.models import register
from motcpp_tpu_torch.models.base import BaseTrackerWrapper
from motcpp_tpu_torch.ops import boxes
from motcpp_tpu_torch.ops.iou import iou_batch, iou_batch_obb
from motcpp_tpu_torch.ops.kalman.xysr import (
    DIM_X,
    XYSRParams,
    xysr_init,
    xysr_predict,
    xysr_update,
)
from motcpp_tpu_torch.ops.lap import solve_lap_masked
from motcpp_tpu_torch.ops.select import birth_slots, gather_rows


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Reference defaults: sort.hpp:69-77."""

    det_thresh: float = 0.3
    max_age: int = 1
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"
    is_obb: bool = False


class SortState(NamedTuple):
    x: torch.Tensor  # (S, K, 7) KF state
    P: torch.Tensor  # (S, K, 7, 7) KF covariance
    ang: torch.Tensor  # (S, K) box angle (OBB mode; zeros for AABB)
    active: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) float32
    cls: torch.Tensor  # (S, K) float32
    det_ind: torch.Tensor  # (S, K) int32
    hits: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32, time since update
    age: torch.Tensor  # (S, K) int32
    next_id: torch.Tensor  # (S,) int32, the last id handed out
    frame_count: torch.Tensor  # (S,) int32


def _obb_measurement(rows):
    """(cx, cy, w*h, w/h) of [cx, cy, w, h, ...] rows."""
    return torch.stack([rows[..., 0], rows[..., 1], rows[..., 2] * rows[..., 3],
                        rows[..., 2] / rows[..., 3].clamp_min(1e-6)], -1)


def _obb_of_state(x, ang):
    """[cx, cy, w, h, angle] of XYSR states."""
    s_ = x[..., 2].clamp_min(1e-6)
    r_ = x[..., 3].clamp_min(1e-6)
    return torch.stack([x[..., 0], x[..., 1], torch.sqrt(s_ * r_),
                        torch.sqrt(s_ / r_), ang], -1)


def make_sort(cfg: SortConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> SortState`` and
    ``step_fn(state, dets (S, N, 6 or 7), det_mask (S, N)) ->
    (state, (out (S, K, 8 or 9), out_mask (S, K)))``."""
    K = cfg.max_tracks
    dev = resolve_device(device)
    kf = XYSRParams()  # SORT uses the raw filter defaults (sort.cpp:29)
    CONF = 5 if cfg.is_obb else 4
    CLS = 6 if cfg.is_obb else 5

    def init_fn(n_streams: int = 1) -> SortState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        return SortState(
            x=zeros(K, DIM_X, dtype=torch.float32),
            P=torch.eye(DIM_X, device=dev).expand(S, K, DIM_X, DIM_X).clone(),
            ang=zeros(K, dtype=torch.float32),
            active=zeros(K, dtype=torch.bool),
            tid=zeros(K),
            conf=zeros(K, dtype=torch.float32),
            cls=zeros(K, dtype=torch.float32),
            det_ind=torch.full((S, K), -1, dtype=torch.int32, device=dev),
            hits=zeros(K),
            tsu=zeros(K),
            age=zeros(K),
            next_id=zeros(),
            frame_count=zeros(),
        )

    def step_fn(state: SortState, dets, det_mask, embs=None):
        """One frame of all streams; ``embs`` is ignored
        (sort.cpp:105-106)."""
        del embs
        N = dets.shape[1]
        frame_count = state.frame_count + 1

        # --- confidence filter (sort.cpp:111-122) ------------------------
        valid = det_mask & (dets[..., CONF] >= cfg.det_thresh)

        # --- predict the active slots (sort.cpp:127-135) -----------------
        act = state.active
        px, pP = xysr_predict(state.x, state.P, kf)
        x = torch.where(act[..., None], px, state.x)
        P = torch.where(act[..., None, None], pP, state.P)
        tsu = torch.where(act, state.tsu + 1, state.tsu)
        age = torch.where(act, state.age + 1, state.age)

        # --- NaN prune (sort.cpp:131-137) --------------------------------
        trk_xyxy = boxes.xysr2xyxy(x[..., :4])
        active = act & torch.isfinite(trk_xyxy).all(-1)

        # --- 1 - IoU cost, limit 1 - iou_threshold (sort.cpp:168-178) ----
        if cfg.is_obb:
            cost = 1.0 - iou_batch_obb(_obb_of_state(x, state.ang),
                                       dets[..., :5])
        else:
            cost = 1.0 - iou_batch(trk_xyxy, dets[..., :4])
        r2c, c2r = solve_lap_masked(cost, active, valid,
                                    1.0 - cfg.iou_threshold,
                                    impl=cfg.lap_impl)

        # --- matched updates (sort.cpp:181-193) --------------------------
        matched = r2c >= 0
        j = r2c.clamp(0, N - 1)
        rows = gather_rows(dets, j)
        z = (_obb_measurement(rows) if cfg.is_obb
             else boxes.xyxy2xysr(rows[..., :4]))
        ux, uP = xysr_update(x, P, z, kf)
        x = torch.where(matched[..., None], ux, x)
        P = torch.where(matched[..., None, None], uP, P)
        ang = (torch.where(matched, rows[..., 4], state.ang)
               if cfg.is_obb else state.ang)
        conf = torch.where(matched, rows[..., CONF], state.conf)
        cls = torch.where(matched, rows[..., CLS], state.cls)
        det_ind = torch.where(matched, j, state.det_ind)
        hits = torch.where(matched, state.hits + 1, state.hits)
        tsu = torch.where(matched, 0, tsu)

        # --- births: unmatched valid dets into free slots, in detection
        #     order (sort.cpp:196-204) -------------------------------------
        unmatched_det = valid & (c2r < 0)
        free = ~active
        births, bdet, slot_rank = birth_slots(free, unmatched_det)
        brows = gather_rows(dets, bdet)
        if cfg.is_obb:
            bz = _obb_measurement(brows)
            ang = torch.where(births, brows[..., 4], ang)
        else:
            bz = boxes.xyxy2xysr(brows[..., :4])
        bx, bP = xysr_init(bz, kf)
        x = torch.where(births[..., None], bx, x)
        P = torch.where(births[..., None, None], bP, P)
        conf = torch.where(births, brows[..., CONF], conf)
        cls = torch.where(births, brows[..., CLS], cls)
        det_ind = torch.where(births, bdet, det_ind)
        hits = torch.where(births, 1, hits)
        tsu = torch.where(births, 0, tsu)
        age = torch.where(births, 1, age)
        tid = torch.where(births, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            unmatched_det.sum(1, dtype=torch.int32),
            free.sum(1, dtype=torch.int32))
        active = active | births

        # --- deaths (sort.cpp:206-215) -----------------------------------
        active = active & (tsu <= cfg.max_age)

        # --- output gate (sort.cpp:221-241) ------------------------------
        out_mask = active & (tsu == 0) & (
            (hits >= cfg.min_hits) | (frame_count <= cfg.min_hits)[:, None])
        box = (_obb_of_state(x, ang) if cfg.is_obb
               else boxes.xysr2xyxy(x[..., :4]))
        out = torch.cat(
            [box, tid[..., None].to(torch.float32), conf[..., None],
             cls[..., None], det_ind[..., None].to(torch.float32)],
            dim=-1,
        )
        new_state = SortState(
            x=x, P=P, ang=ang, active=active, tid=tid, conf=conf, cls=cls,
            det_ind=det_ind, hits=hits, tsu=tsu, age=age, next_id=next_id,
            frame_count=frame_count,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("sort")
class Sort(BaseTrackerWrapper):
    """Host-facing SORT (reference: sort.hpp:69-77; eval defaults
    motcpp_eval.cpp:99-111). The first frame with 7-column detections
    rebuilds it in oriented-box mode."""

    def __init__(
        self,
        det_thresh: float = 0.3,
        max_age: int = 1,
        max_obs: int = 50,
        min_hits: int = 3,
        iou_threshold: float = 0.3,
        per_class: bool = False,
        nr_classes: int = 80,
        asso_func: str = "iou",
        is_obb: bool = False,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, device=device)
        # SORT always associates by IoU (sort.cpp:168-170); the rest is
        # accepted for the reference's constructor signature
        del per_class, nr_classes, asso_func
        self._cfg_kw = dict(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self._build(is_obb)

    def _build(self, is_obb: bool):
        self.cfg = SortConfig(**self._cfg_kw, is_obb=is_obb)
        self._init, self._core_step = make_sort(self.cfg, device=self.device)

    def update(self, dets, img=None, embs=None, warp=None):
        d = np.asarray(dets, np.float32)
        if (not self._first_dets_processed and d.size > 0
                and d.shape[1] == 7 and not self.cfg.is_obb):
            self._build(True)
            self._state = None
        return super().update(dets, img, embs, warp=warp)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask)
