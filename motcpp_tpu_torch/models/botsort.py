"""BoT-SORT: ByteTrack's skeleton with ReID fusion and a camera-motion
warp, batched over streams.

Counterpart of ``motcpp_tpu/models/botsort.py``; its module doc lists the
reference behaviours this step replicates (reference:
src/trackers/botsort.cpp:14-845). Every tensor of the state has a
leading stream dimension S, and one call of the step advances all S
streams by one frame. Per frame: a Kalman predict (XYWH) committed in
place for the pool, the warp on pool and unconfirmed means, the stage-1
assignment over S problems on the fused IoU/appearance cost, stages 2
and 3 as one assignment over 2S problems, one merged Kalman update, the
feature EMA, births and lost-track aging; no duplicate removal. A stream
whose frame holds no detection keeps its state and emits nothing, and
its frame count does not move (botsort.cpp:267-269).
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
from motcpp_tpu_torch.ops.kalman.gaussian import kf_xywh
from motcpp_tpu_torch.ops.lap import solve_lap_masked
from motcpp_tpu_torch.ops.matching import fuse_score
from motcpp_tpu_torch.ops.select import birth_slots, gather_rows

FREE = 0
TRACKED = 1
LOST = 2

_EMA_ALPHA = 0.9  # feature alpha (botsort.cpp:163)


@dataclasses.dataclass(frozen=True)
class BotSortConfig:
    """Reference defaults: botsort.hpp:108-134."""

    det_thresh: float = 0.3
    max_age: int = 30
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    track_high_thresh: float = 0.5
    track_low_thresh: float = 0.1
    new_track_thresh: float = 0.6
    track_buffer: int = 30
    match_thresh: float = 0.8
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.25
    cmc_method: str = "ecc"
    frame_rate: int = 30
    fuse_first_associate: bool = False
    with_reid: bool = True
    emb_dim: int = 1
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"

    @property
    def max_time_lost(self) -> int:
        return int(self.frame_rate / 30.0 * self.track_buffer)


class BotState(NamedTuple):
    mean: torch.Tensor  # (S, K, 8) XYWH KF mean
    cov: torch.Tensor  # (S, K, 8, 8)
    tstate: torch.Tensor  # (S, K) int32 in {FREE, TRACKED, LOST}
    is_activated: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) float32
    cls: torch.Tensor  # (S, K) float32
    det_ind: torch.Tensor  # (S, K) int32
    start_frame: torch.Tensor  # (S, K) int32
    end_frame: torch.Tensor  # (S, K) int32
    feat: torch.Tensor  # (S, K, D) EMA feature, L2-normalized
    has_feat: torch.Tensor  # (S, K) bool
    next_id: torch.Tensor  # (S,) int32
    frame_count: torch.Tensor  # (S,) int32


_STATE_DTYPES = {
    "mean": torch.float32, "cov": torch.float32, "tstate": torch.int32,
    "is_activated": torch.bool, "tid": torch.int32, "conf": torch.float32,
    "cls": torch.float32, "det_ind": torch.int32,
    "start_frame": torch.int32, "end_frame": torch.int32,
    "feat": torch.float32, "has_feat": torch.bool,
    "next_id": torch.int32, "frame_count": torch.int32,
}


def state_from_numpy(arrays: dict, device="cuda") -> BotState:
    """BotState from a dict of arrays named as its fields, each with a
    leading stream dimension (for example a JAX state converted with
    ``np.asarray``)."""
    dev = resolve_device(device)
    return BotState(**{
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)
        for name, dtype in _STATE_DTYPES.items()
    })


def state_to_numpy(state: BotState) -> dict:
    """Inverse of :func:`state_from_numpy`."""
    return {name: t.cpu().numpy() for name, t in state._asdict().items()}


def _emb_distance(track_feat, det_feat):
    """Cosine distance (S, K, N) of (S, K, D) and (S, N, D) features
    (utils/matching.cpp:79-91)."""
    tn = torch.linalg.vector_norm(track_feat, dim=-1, keepdim=True)
    dn = torch.linalg.vector_norm(det_feat, dim=-1, keepdim=True)
    sim = torch.matmul(track_feat, det_feat.transpose(-1, -2)) / (
        tn * dn.transpose(-1, -2) + 1e-10)
    return torch.clamp_min(1.0 - sim, 0.0)


def _normalize_rows(v):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 0, n, 1.0), n[..., 0]


def make_botsort(cfg: BotSortConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> BotState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N), embs=None
    (S, N, >= D), warp=None (S, 2, 3)) -> (state, (out (S, K, 8),
    out_mask (S, K)))``."""
    K = cfg.max_tracks
    D = cfg.emb_dim
    dev = resolve_device(device)

    def init_fn(n_streams: int = 1) -> BotState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        return BotState(
            mean=zeros(K, 8, dtype=torch.float32),
            cov=torch.eye(8, device=dev).expand(S, K, 8, 8).clone(),
            tstate=zeros(K),
            is_activated=zeros(K, dtype=torch.bool),
            tid=zeros(K),
            conf=zeros(K, dtype=torch.float32),
            cls=zeros(K, dtype=torch.float32),
            det_ind=torch.full((S, K), -1, dtype=torch.int32, device=dev),
            start_frame=zeros(K),
            end_frame=zeros(K),
            feat=torch.ones((S, K, D), device=dev),
            has_feat=zeros(K, dtype=torch.bool),
            next_id=zeros(),
            frame_count=zeros(),
        )

    def _fused_cost(trk_xyxy, det_xyxy, det_conf, trk_feat, trk_has_feat,
                    det_feat, det_has_feat, use_fuse_score):
        """min(iou_dist, masked emb_dist / 2) (botsort.cpp:437-466)."""
        iou_d = 1.0 - iou_batch(trk_xyxy, det_xyxy)
        iou_mask = iou_d > cfg.proximity_thresh
        base = fuse_score(iou_d, det_conf) if use_fuse_score else iou_d
        if not cfg.with_reid:
            return base
        emb_d = _emb_distance(trk_feat, det_feat) / 2.0
        # pairs lacking features behave like the reference's zero-filled
        # rows: cosine 0 -> distance 1 -> halved
        no_feat = ~(trk_has_feat[:, :, None] & det_has_feat[:, None, :])
        emb_d = torch.where(no_feat, 0.5, emb_d)
        emb_d = torch.where(emb_d > cfg.appearance_thresh, 1.0, emb_d)
        emb_d = torch.where(iou_mask, 1.0, emb_d)
        return torch.minimum(base, emb_d)

    def _ema_feat(feat, has_feat, m, det_feat_rows, det_has_rows):
        """update_features (botsort.cpp:158-169)."""
        do = m & det_has_rows
        new = _EMA_ALPHA * feat + (1.0 - _EMA_ALPHA) * det_feat_rows
        new = torch.where(has_feat[..., None], new, det_feat_rows)
        new, _ = _normalize_rows(new)
        return torch.where(do[..., None], new, feat), has_feat | do

    def step_fn(state: BotState, dets, det_mask, embs=None, warp=None):
        S, N, _ = dets.shape
        det_conf = dets[..., 4]
        det_xyxy = dets[..., :4]
        if embs is None:
            dets_feat = torch.ones((S, N, D), device=dets.device)
            det_has_feat = torch.zeros((S, N), dtype=torch.bool,
                                       device=dets.device)
        else:
            dets_feat, norms = _normalize_rows(embs[..., :D])
            det_has_feat = det_mask & (norms > 0)

        empty_input = ~det_mask.any(1)  # (S,)
        frame = state.frame_count + 1

        first = det_mask & (det_conf > cfg.track_high_thresh)
        second = det_mask & (det_conf > cfg.track_low_thresh) & (
            det_conf <= cfg.track_high_thresh)

        tracked_m = (state.tstate == TRACKED) & state.is_activated
        unconf_m = (state.tstate == TRACKED) & ~state.is_activated
        pool_m = tracked_m | (state.tstate == LOST)

        conf, cls, det_ind = state.conf, state.cls, state.det_ind
        tstate, is_act = state.tstate, state.is_activated
        end_frame, start_frame = state.end_frame, state.start_frame
        feat, has_feat = state.feat, state.has_feat

        # --- predict the pool in place (botsort.cpp:313-314) -------------
        pmean, pcov = kf_xywh.predict(state.mean, state.cov)
        mean = torch.where(pool_m[..., None], pmean, state.mean)
        cov = torch.where(pool_m[..., None, None], pcov, state.cov)

        # --- GMC warp of pool and unconfirmed means (botsort.cpp:60-91) --
        if warp is not None:
            occ = pool_m | unconf_m
            cur = boxes.xywh2xyxy(mean[..., :4])
            ones = torch.ones_like(cur[..., :1])
            wt = warp.transpose(-1, -2)  # (S, 3, 2)
            w1 = torch.matmul(torch.cat([cur[..., 0:2], ones], -1), wt)
            w2 = torch.matmul(torch.cat([cur[..., 2:4], ones], -1), wt)
            new_xywh = boxes.xyxy2xywh(torch.cat([w1, w2], -1))
            mean = torch.where(occ[..., None],
                               torch.cat([new_xywh, mean[..., 4:]], -1), mean)

        trk_xyxy = boxes.xywh2xyxy(mean[..., :4])

        # ================= stage 1: pool x first dets ====================
        cost1 = _fused_cost(trk_xyxy, det_xyxy, det_conf, feat, has_feat,
                            dets_feat, det_has_feat, cfg.fuse_first_associate)
        r2c1, c2r1 = solve_lap_masked(cost1, pool_m, first, cfg.match_thresh,
                                      impl=cfg.lap_impl)
        m1 = r2c1 >= 0

        # ============ stages 2+3: one solve over 2S problems =============
        # Both depend only on stage 1 and touch disjoint rows and
        # columns, as in the JAX package (botsort.py:225-251).
        r_tracked = tracked_m & ~m1
        gate2 = (second.any(1) & r_tracked.any(1))[:, None]
        cost2 = 1.0 - iou_batch(trk_xyxy, det_xyxy)
        rem_first = first & (c2r1 < 0)
        gate3 = (unconf_m.any(1) & rem_first.any(1))[:, None]
        cost3 = _fused_cost(trk_xyxy, det_xyxy, det_conf, feat, has_feat,
                            dets_feat, det_has_feat, True)
        th23 = torch.cat([torch.full((S,), 0.5, device=dets.device),
                          torch.full((S,), 0.7, device=dets.device)])
        r2c23, c2r23 = solve_lap_masked(
            torch.cat([cost2, cost3]),
            torch.cat([r_tracked & gate2, unconf_m & gate3]),
            torch.cat([second & gate2, rem_first & gate3]),
            th23, impl=cfg.lap_impl,
        )
        r2c2, r2c3, c2r3 = r2c23[:S], r2c23[S:], c2r23[S:]
        m2 = r2c2 >= 0
        m3 = r2c3 >= 0

        # ============ one merged KF update for all three stages ==========
        m123 = m1 | m2 | m3
        j123 = torch.where(m1, r2c1, torch.where(m2, r2c2, r2c3)).clamp(0, N - 1)
        drow = gather_rows(dets, j123)
        um, uc = kf_xywh.update(mean, cov, boxes.xyxy2xywh(drow[..., :4]))
        mean = torch.where(m123[..., None], um, mean)
        cov = torch.where(m123[..., None, None], uc, cov)
        conf = torch.where(m123, drow[..., 4], conf)
        cls = torch.where(m123, drow[..., 5], cls)
        det_ind = torch.where(m123, j123, det_ind)
        end_frame = torch.where(m123, frame[:, None], end_frame)
        tstate = torch.where(m1, TRACKED, tstate)  # re_activate of Lost
        is_act = is_act | m123
        # feature EMA for stages 1 and 3 only: second-stage dets carry no
        # features (botsort.cpp:507-511)
        feat, has_feat = _ema_feat(
            feat, has_feat, m1 | m3, gather_rows(dets_feat, j123),
            det_has_feat.gather(1, j123.long()))
        # unmatched leftover Tracked -> Lost (only when stage 2 ran)
        tstate = torch.where(r_tracked & ~m2 & gate2, LOST, tstate)
        tstate = torch.where(unconf_m & ~m3 & gate3, FREE, tstate)

        # ================= births =======================================
        newt = rem_first & (c2r3 < 0) & (det_conf >= cfg.new_track_thresh)
        free = tstate == FREE
        births, bdet, slot_rank = birth_slots(free, newt)
        brow = gather_rows(dets, bdet)
        bmean, bcov = kf_xywh.initiate(boxes.xyxy2xywh(brow[..., :4]))
        mean = torch.where(births[..., None], bmean, mean)
        cov = torch.where(births[..., None, None], bcov, cov)
        conf = torch.where(births, brow[..., 4], conf)
        cls = torch.where(births, brow[..., 5], cls)
        det_ind = torch.where(births, bdet, det_ind)
        tstate = torch.where(births, TRACKED, tstate)
        is_act = torch.where(births, (frame == 1)[:, None], is_act)
        tid = torch.where(births, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            newt.sum(1, dtype=torch.int32), free.sum(1, dtype=torch.int32))
        start_frame = torch.where(births, frame[:, None], start_frame)
        end_frame = torch.where(births, frame[:, None], end_frame)
        feat = torch.where(births[..., None], gather_rows(dets_feat, bdet), feat)
        has_feat = torch.where(births, det_has_feat.gather(1, bdet.long()),
                               has_feat)

        # ================= lost aging (botsort.cpp:669-676) ==============
        aged = (tstate == LOST) & (frame[:, None] - end_frame
                                   > cfg.max_time_lost)
        tstate = torch.where(aged, FREE, tstate)

        # ================= output (no duplicate removal) =================
        out_mask = (tstate == TRACKED) & is_act
        out = torch.cat(
            [boxes.xywh2xyxy(mean[..., :4]), tid[..., None].to(torch.float32),
             conf[..., None], cls[..., None],
             det_ind[..., None].to(torch.float32)],
            dim=-1,
        )
        new_state = BotState(
            mean=mean, cov=cov, tstate=tstate, is_activated=is_act, tid=tid,
            conf=conf, cls=cls, det_ind=det_ind, start_frame=start_frame,
            end_frame=end_frame, feat=feat, has_feat=has_feat,
            next_id=next_id, frame_count=frame,
        )

        # --- empty input (botsort.cpp:267-269): the stream's state
        #     passes through, nothing is emitted, the frame stays --------
        def keep(old, new):
            e = empty_input.reshape((S,) + (1,) * (new.dim() - 1))
            return torch.where(e, old, new)

        final = BotState(*(keep(o, n) for o, n in zip(state, new_state)))
        return final, (out, out_mask & ~empty_input[:, None])

    return init_fn, step_fn


@register("botsort")
class BotSort(BaseTrackerWrapper):
    """Host-facing BoT-SORT (reference: botsort.hpp:108-134 defaults).
    With ``reid_weights`` and no embeddings given, features are computed
    from ``img`` by the port's ReID backend on ``device``."""

    def __init__(
        self,
        reid_weights: str = "",
        use_half: bool = False,
        use_gpu: bool = False,
        det_thresh: float = 0.3,
        max_age: int = 30,
        max_obs: int = 50,
        min_hits: int = 3,
        iou_threshold: float = 0.3,
        per_class: bool = False,
        nr_classes: int = 80,
        asso_func: str = "iou",
        is_obb: bool = False,
        track_high_thresh: float = 0.5,
        track_low_thresh: float = 0.1,
        new_track_thresh: float = 0.6,
        track_buffer: int = 30,
        match_thresh: float = 0.8,
        proximity_thresh: float = 0.5,
        appearance_thresh: float = 0.25,
        cmc_method: str = "ecc",
        frame_rate: int = 30,
        fuse_first_associate: bool = False,
        with_reid: bool = True,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        emb_dim: int = 1,
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, emb_dim=emb_dim, device=device)
        # accepted for the reference's constructor signature; unused
        del per_class, nr_classes, asso_func, is_obb, use_half, use_gpu
        self._cfg_kw = dict(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            track_high_thresh=track_high_thresh,
            track_low_thresh=track_low_thresh,
            new_track_thresh=new_track_thresh,
            track_buffer=track_buffer,
            match_thresh=match_thresh,
            proximity_thresh=proximity_thresh,
            appearance_thresh=appearance_thresh,
            cmc_method=cmc_method,
            frame_rate=frame_rate,
            fuse_first_associate=fuse_first_associate,
            with_reid=with_reid,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self.reid_weights = reid_weights
        self._reid = None
        self._cmc = None
        self._build(emb_dim)

    def _build(self, emb_dim: int):
        self.cfg = BotSortConfig(**self._cfg_kw, emb_dim=emb_dim)
        self._init, self._core_step = make_botsort(self.cfg, device=self.device)

    def update(self, dets, img=None, embs=None, warp=None):
        dets = np.asarray(dets, np.float32)
        # the reference returns at once on empty input, without frame
        # bookkeeping (botsort.cpp:267-269)
        if dets.size == 0:
            return np.zeros((0, 8), np.float32)
        embs_arr = None if embs is None else np.asarray(embs, np.float32)
        if (embs_arr is not None and embs_arr.size > 0
                and embs_arr.shape[1] != self.cfg.emb_dim):
            self.emb_dim = embs_arr.shape[1]
            self._build(embs_arr.shape[1])
            self._state = None
        if ((embs_arr is None or embs_arr.size == 0) and self.cfg.with_reid
                and self.reid_weights and img is not None):
            embs_arr = self._reid_features(dets, img)
            if embs_arr.shape[1] != self.cfg.emb_dim:
                self.emb_dim = embs_arr.shape[1]
                self._build(embs_arr.shape[1])
        return super().update(dets, img, embs_arr, warp=warp)

    def _compute_warp(self, img, dets):
        # GMC (botsort.cpp:239-242, 316-324)
        if img is None or self.cfg.cmc_method not in ("ecc", "sof", "sof_jax"):
            return None
        if self._cmc is None:
            from motcpp_tpu_torch.motion.cmc import create_cmc

            self._cmc = create_cmc(self.cfg.cmc_method, device=self.device)
        return None if self._cmc is None else self._cmc.apply(img, dets)

    def _reid_features(self, dets, img):
        if self._reid is None:
            from motcpp_tpu_torch.appearance.reid import ReIDBackend

            self._reid = ReIDBackend(self.reid_weights, device=self.device)
        return self._reid.get_features(dets[:, :4], img)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask, embs, warp=warp)
