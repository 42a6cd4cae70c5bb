"""ByteTrack: two-stage high/low-score association over slot state,
batched over streams.

Counterpart of ``motcpp_tpu/models/bytetrack.py``; its module doc lists
the reference behaviours this step replicates. Every tensor of the state
has a leading stream dimension S, and one call of the step advances all
S streams by one frame: the stream batch that ``jax.vmap`` makes in the
JAX package is written out here. Per frame it runs one Kalman predict
over all K slots, the stage-1 assignment over S problems, stages 2 and 3
as one assignment over 2S problems, one merged Kalman update, births,
lost-track aging and duplicate removal.
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
from motcpp_tpu_torch.ops.iou import iou_batch
from motcpp_tpu_torch.ops.kalman.gaussian import kf_xyah
from motcpp_tpu_torch.ops.lap import solve_lap_masked
from motcpp_tpu_torch.ops.matching import fuse_score
from motcpp_tpu_torch.ops.select import birth_slots, gather_rows

FREE = 0
TRACKED = 1
LOST = 2


@dataclasses.dataclass(frozen=True)
class ByteTrackConfig:
    """Reference defaults: bytetrack.hpp:97-110."""

    det_thresh: float = 0.3  # overridden to track_thresh like the ctor
    max_age: int = 30
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    min_conf: float = 0.1
    track_thresh: float = 0.45
    match_thresh: float = 0.8
    track_buffer: int = 25
    frame_rate: int = 30
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"

    @property
    def max_time_lost(self) -> int:
        return int(self.frame_rate / 30.0 * self.track_buffer)


class ByteState(NamedTuple):
    mean: torch.Tensor  # (S, K, 8) XYAH KF mean
    cov: torch.Tensor  # (S, K, 8, 8)
    tstate: torch.Tensor  # (S, K) int32 in {FREE, TRACKED, LOST}
    is_activated: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) float32
    cls: torch.Tensor  # (S, K) float32
    det_ind: torch.Tensor  # (S, K) int32
    start_frame: torch.Tensor  # (S, K) int32
    last_frame: torch.Tensor  # (S, K) int32, frame of the last update
    next_id: torch.Tensor  # (S,) int32
    frame_id: torch.Tensor  # (S,) int32


_STATE_DTYPES = {
    "mean": torch.float32, "cov": torch.float32, "tstate": torch.int32,
    "is_activated": torch.bool, "tid": torch.int32, "conf": torch.float32,
    "cls": torch.float32, "det_ind": torch.int32,
    "start_frame": torch.int32, "last_frame": torch.int32,
    "next_id": torch.int32, "frame_id": torch.int32,
}


def state_from_numpy(arrays: dict, device="cuda") -> ByteState:
    """ByteState from a dict of arrays named as its fields, each with a
    leading stream dimension (for example a JAX state taken mid-sequence
    and converted with ``np.asarray``)."""
    dev = resolve_device(device)
    return ByteState(**{
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)
        for name, dtype in _STATE_DTYPES.items()
    })


def state_to_numpy(state: ByteState) -> dict:
    """Inverse of :func:`state_from_numpy`."""
    return {name: t.cpu().numpy() for name, t in state._asdict().items()}


def make_bytetrack(cfg: ByteTrackConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> ByteState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N)) ->
    (state, (out (S, K, 8), out_mask (S, K)))``."""
    K = cfg.max_tracks
    dev = resolve_device(device)

    def init_fn(n_streams: int = 1) -> ByteState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        return ByteState(
            mean=zeros(K, 8, dtype=torch.float32),
            cov=torch.eye(8, device=dev).expand(S, K, 8, 8).clone(),
            tstate=zeros(K),
            is_activated=zeros(K, dtype=torch.bool),
            tid=zeros(K),
            conf=zeros(K, dtype=torch.float32),
            cls=zeros(K, dtype=torch.float32),
            det_ind=torch.full((S, K), -1, dtype=torch.int32, device=dev),
            start_frame=zeros(K),
            last_frame=zeros(K),
            next_id=zeros(),
            frame_id=zeros(),
        )

    def step_fn(state: ByteState, dets: torch.Tensor, det_mask: torch.Tensor):
        S, N, _ = dets.shape
        frame = state.frame_id + 1
        det_conf = dets[..., 4]
        det_xyxy = dets[..., :4]

        # --- det splits (strict, bytetrack.cpp:189-193) ------------------
        high = det_mask & (det_conf > cfg.track_thresh)
        second = det_mask & (det_conf > cfg.min_conf) & (
            det_conf < cfg.track_thresh)

        tstate, is_act = state.tstate, state.is_activated
        tracked_m = (tstate == TRACKED) & is_act
        unconf_m = (tstate == TRACKED) & ~is_act
        pool_m = tracked_m | (tstate == LOST)
        mean, cov = state.mean, state.cov
        conf, cls, det_ind = state.conf, state.cls, state.det_ind
        last_frame, start_frame = state.last_frame, state.start_frame

        # --- predict pool copies, vh zeroed for non-Tracked
        #     (bytetrack.cpp:87-95) -----------------------------------------
        mean_in = mean.clone()
        mean_in[..., 7] = torch.where(tstate == TRACKED, mean[..., 7], 0.0)
        pmean, pcov = kf_xyah.predict(mean_in, cov)
        pool_xyxy = boxes.xyah2xyxy(pmean[..., :4])

        # ================= stage 1: pool x high dets =====================
        cost1 = fuse_score(1.0 - iou_batch(pool_xyxy, det_xyxy), det_conf)
        r2c1, c2r1 = solve_lap_masked(cost1, pool_m, high, cfg.match_thresh,
                                      impl=cfg.lap_impl)
        m1 = r2c1 >= 0

        # ============ stages 2+3: one solve over 2S problems =============
        # Stage 2 (leftover Tracked x low dets, costs from the
        # UNPREDICTED boxes, bytetrack.cpp:388-397) and stage 3
        # (unconfirmed x stage-1-leftover high dets) touch disjoint rows
        # and columns and depend only on stage 1, as in the JAX package.
        r_tracked = tracked_m & ~m1
        gate2 = (second.any(1) & r_tracked.any(1))[:, None]
        iou_orig = 1.0 - iou_batch(boxes.xyah2xyxy(mean[..., :4]), det_xyxy)
        rem_high = high & (c2r1 < 0)
        gate3 = (unconf_m.any(1) & rem_high.any(1))[:, None]
        th23 = torch.cat([torch.full((S,), 0.5, device=dets.device),
                          torch.full((S,), 0.7, device=dets.device)])
        r2c23, c2r23 = solve_lap_masked(
            torch.cat([iou_orig, fuse_score(iou_orig, det_conf)]),
            torch.cat([r_tracked & gate2, unconf_m & gate3]),
            torch.cat([second & gate2, rem_high & gate3]),
            th23, impl=cfg.lap_impl,
        )
        r2c2, r2c3, c2r3 = r2c23[:S], r2c23[S:], c2r23[S:]
        m2 = r2c2 >= 0
        m3 = r2c3 >= 0

        # ============ one merged KF update for all three stages ==========
        # Stages 1 and 2 update the predicted state; stage 3's unconfirmed
        # tracks were never predicted and update their stored state.
        m12 = m1 | m2
        m123 = m12 | m3
        j123 = torch.where(m1, r2c1, torch.where(m2, r2c2, r2c3)).clamp(0, N - 1)
        drow = gather_rows(dets, j123)
        z = boxes.xyxy2xyah(drow[..., :4])
        base_mean = torch.where(m12[..., None], pmean, mean)
        base_cov = torch.where(m12[..., None, None], pcov, cov)
        u_mean, u_cov = kf_xyah.update(base_mean, base_cov, z)
        mean = torch.where(m123[..., None], u_mean, mean)
        cov = torch.where(m123[..., None, None], u_cov, cov)
        conf = torch.where(m123, drow[..., 4], conf)
        cls = torch.where(m123, drow[..., 5], cls)
        det_ind = torch.where(m123, j123, det_ind)
        last_frame = torch.where(m123, frame[:, None], last_frame)
        tstate = torch.where(m1, TRACKED, tstate)  # re_activate of Lost
        is_act = is_act | m123
        # unmatched leftover Tracked -> Lost (only when stage 2 ran)
        tstate = torch.where(r_tracked & ~m2 & gate2, LOST, tstate)
        # unmatched unconfirmed -> removed, only when stage 3 ran
        tstate = torch.where(unconf_m & ~m3 & gate3, FREE, tstate)

        # ================= births =======================================
        newt = rem_high & (c2r3 < 0) & (det_conf >= cfg.track_thresh)
        free = tstate == FREE
        births, bdet, slot_rank = birth_slots(free, newt)
        brows = gather_rows(dets, bdet)
        bmean, bcov = kf_xyah.initiate(boxes.xyxy2xyah(brows[..., :4]))
        mean = torch.where(births[..., None], bmean, mean)
        cov = torch.where(births[..., None, None], bcov, cov)
        conf = torch.where(births, brows[..., 4], conf)
        cls = torch.where(births, brows[..., 5], cls)
        det_ind = torch.where(births, bdet, det_ind)
        tstate = torch.where(births, TRACKED, tstate)
        is_act = torch.where(births, (frame == 1)[:, None], is_act)
        tid = torch.where(births, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            newt.sum(1, dtype=torch.int32), free.sum(1, dtype=torch.int32))
        start_frame = torch.where(births, frame[:, None], start_frame)
        last_frame = torch.where(births, frame[:, None], last_frame)

        # ================= lost aging (bytetrack.cpp:557-562) ============
        aged = (tstate == LOST) & (frame[:, None] - last_frame
                                   > cfg.max_time_lost)
        tstate = torch.where(aged, FREE, tstate)

        # ================= duplicate removal =============================
        cur_xyxy = boxes.xyah2xyxy(mean[..., :4])
        pd = 1.0 - iou_batch(cur_xyxy, cur_xyxy)  # (S, K, K)
        pair = ((tstate == TRACKED)[:, :, None] & (tstate == LOST)[:, None, :]
                & (pd < 0.15))
        life = last_frame - start_frame
        timep = life[:, :, None]
        timeq = life[:, None, :]
        dup_lost = (pair & (timep > timeq)).any(1)  # cols to drop
        dup_trk = (pair & (timep <= timeq)).any(2)  # rows to drop
        tstate = torch.where(dup_lost | dup_trk, FREE, tstate)

        # ================= output ========================================
        out_mask = (tstate == TRACKED) & is_act
        out = torch.cat(
            [cur_xyxy, tid[..., None].to(torch.float32), conf[..., None],
             cls[..., None], det_ind[..., None].to(torch.float32)],
            dim=-1,
        )
        new_state = ByteState(
            mean=mean, cov=cov, tstate=tstate, is_activated=is_act, tid=tid,
            conf=conf, cls=cls, det_ind=det_ind, start_frame=start_frame,
            last_frame=last_frame, next_id=next_id, frame_id=frame,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("bytetrack")
class ByteTrack(BaseTrackerWrapper):
    """Host-facing ByteTrack (reference: bytetrack.hpp:97-110 defaults)."""

    def __init__(
        self,
        det_thresh: float = 0.3,
        max_age: int = 30,
        max_obs: int = 50,
        min_hits: int = 3,
        iou_threshold: float = 0.3,
        min_conf: float = 0.1,
        track_thresh: float = 0.45,
        match_thresh: float = 0.8,
        track_buffer: int = 25,
        frame_rate: int = 30,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, device=device)
        self.cfg = ByteTrackConfig(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            min_conf=min_conf,
            track_thresh=track_thresh,
            match_thresh=match_thresh,
            track_buffer=track_buffer,
            frame_rate=frame_rate,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self._init, self._core_step = make_bytetrack(self.cfg,
                                                     device=self.device)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask)
