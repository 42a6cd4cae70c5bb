"""StrongSORT: DeepSORT's association with NSA Kalman updates and
per-track feature galleries, batched over streams.

Counterpart of ``motcpp_tpu/models/strongsort.py``; its module doc lists
the reference behaviours this step replicates (reference:
src/trackers/strongsort.cpp:20-1023). Every tensor of the state has a
leading stream dimension S, and one call of the step advances all S
streams by one frame:

  * the optional camera update of every occupied slot before predict;
  * one XYAH Kalman predict;
  * stage A: the minimum cosine distance of each detection to each
    confirmed track's gallery ring (S, K, B, D), Mahalanobis-gated and
    blended with the gating distance, one assignment over S problems;
  * stage B: 1 - IoU on tentative and just-missed tracks, one
    assignment over S problems;
  * one NSA Kalman update, the feature EMA, the lifecycle, births, and
    the gallery append of every confirmed track.
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
from motcpp_tpu_torch.ops.select import birth_slots, gather_rows, take_slot

FREE = 0
TENTATIVE = 1
CONFIRMED = 2

INFTY_COST = 1e5
GATING_THRESHOLD = 9.4877  # chi2inv95[4] (strongsort.cpp:461)


@dataclasses.dataclass(frozen=True)
class StrongSortConfig:
    """Reference defaults: strongsort.hpp:305-324."""

    det_thresh: float = 0.3
    max_age: int = 30
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    min_conf: float = 0.1
    max_cos_dist: float = 0.2
    max_iou_dist: float = 0.7
    n_init: int = 3
    nn_budget: int = 100
    mc_lambda: float = 0.98
    ema_alpha: float = 0.9
    emb_dim: int = 1
    gallery_cap: int = 100  # ring size (= min(nn_budget, cap))
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"

    @property
    def gallery(self) -> int:
        return min(self.nn_budget, self.gallery_cap)


class StrongSortState(NamedTuple):
    mean: torch.Tensor  # (S, K, 8) XYAH
    cov: torch.Tensor  # (S, K, 8, 8)
    sstate: torch.Tensor  # (S, K) int32 in {FREE, TENTATIVE, CONFIRMED}
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) float32
    cls: torch.Tensor  # (S, K) float32
    det_ind: torch.Tensor  # (S, K) int32
    hits: torch.Tensor  # (S, K) int32
    age: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32, time since update
    feat: torch.Tensor  # (S, K, D) smoothed feature
    has_feat: torch.Tensor  # (S, K) bool
    gallery: torch.Tensor  # (S, K, B, D) ring of smoothed features
    gallery_count: torch.Tensor  # (S, K) int32, total appended
    next_id: torch.Tensor  # (S,) int32
    frame_count: torch.Tensor  # (S,) int32


def _unit_rows(v):
    """v / |v| where |v| > 1e-10 (else v), and |v|."""
    n = torch.linalg.vector_norm(v, dim=-1)
    return v / torch.where(n > 1e-10, n, 1.0)[..., None], n


def make_strongsort(cfg: StrongSortConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> StrongSortState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N), embs=None
    (S, N, >= D), warp=None (S, 2, 3)) -> (state, (out (S, K, 8),
    out_mask (S, K)))``."""
    K = cfg.max_tracks
    B = cfg.gallery
    D = cfg.emb_dim
    dev = resolve_device(device)

    def init_fn(n_streams: int = 1) -> StrongSortState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        return StrongSortState(
            mean=zeros(K, 8, dtype=torch.float32),
            cov=torch.eye(8, device=dev).expand(S, K, 8, 8).clone(),
            sstate=zeros(K),
            tid=zeros(K),
            conf=zeros(K, dtype=torch.float32),
            cls=zeros(K, dtype=torch.float32),
            det_ind=torch.full((S, K), -1, dtype=torch.int32, device=dev),
            hits=zeros(K),
            age=zeros(K),
            tsu=zeros(K),
            feat=zeros(K, D, dtype=torch.float32),
            has_feat=zeros(K, dtype=torch.bool),
            gallery=zeros(K, B, D, dtype=torch.float32),
            gallery_count=zeros(K),
            next_id=zeros(),
            frame_count=zeros(),
        )

    def step_fn(state: StrongSortState, dets, det_mask, embs=None, warp=None):
        S, N = dets.shape[:2]
        frame = state.frame_count + 1
        det_conf = dets[..., 4]
        det_xyxy = dets[..., :4]
        det_xyah = boxes.xyxy2xyah(det_xyxy)

        valid = det_mask & (det_conf >= cfg.min_conf)
        if embs is None:
            det_feat = torch.zeros((S, N, D), device=dets.device)
        else:
            det_feat = embs[..., :D]
        det_feat_n, det_feat_norm = _unit_rows(det_feat)
        det_has_feat = valid & (det_feat_norm > 1e-10)

        occupied = state.sstate != FREE
        mean, cov = state.mean, state.cov

        # --- camera update before predict (strongsort.cpp:915-921) -------
        if warp is not None:
            tlbr = boxes.tlwh2xyxy(boxes.xyah2tlwh(mean[..., :4]))
            ones = torch.ones_like(tlbr[..., :1])
            wt = warp.transpose(-1, -2)  # (S, 3, 2)
            p1 = torch.matmul(torch.cat([tlbr[..., 0:2], ones], -1), wt)
            p2 = torch.matmul(torch.cat([tlbr[..., 2:4], ones], -1), wt)
            w = p2[..., 0] - p1[..., 0]
            h = p2[..., 1] - p1[..., 1]
            new_pos = torch.stack(
                [p1[..., 0] + w / 2.0, p1[..., 1] + h / 2.0,
                 w / torch.where(h != 0, h, 1.0), h], -1)
            apply = occupied & valid.any(1)[:, None]
            mean = torch.where(apply[..., None],
                               torch.cat([new_pos, mean[..., 4:]], -1), mean)

        # --- predict (strongsort.cpp:139-145) ----------------------------
        pmean, pcov = kf_xyah.predict(mean, cov)
        mean = torch.where(occupied[..., None], pmean, mean)
        cov = torch.where(occupied[..., None, None], pcov, cov)
        age = torch.where(occupied, state.age + 1, state.age)
        tsu = torch.where(occupied, state.tsu + 1, state.tsu)

        confirmed = state.sstate == CONFIRMED
        tentative = state.sstate == TENTATIVE

        # --- stage A: gallery cosine + Mahalanobis gate ------------------
        g_n, _ = _unit_rows(state.gallery)
        sims = torch.matmul(g_n.reshape(S, K * B, D),
                            det_feat_n.transpose(1, 2)).reshape(S, K, B, N)
        have = (torch.arange(B, device=dets.device)[:, None]
                < state.gallery_count.clamp(max=B)[..., None, None])
        nn_cost = torch.where(have, 1.0 - sims, torch.inf).amin(2)  # (S, K, N)
        g_any = (state.gallery_count > 0)[..., None]
        nn_cost = torch.where(g_any, nn_cost, INFTY_COST)
        # dets without features behave like the reference's zero rows:
        # cosine against a zero vector, distance 1
        nn_cost = torch.where(det_has_feat[:, None, :], nn_cost,
                              torch.where(g_any, 1.0, INFTY_COST))
        maha = kf_xyah.gating_distance(mean, cov, det_xyah[:, None])
        costA = torch.where(maha > GATING_THRESHOLD, INFTY_COST, nn_cost)
        costA = cfg.mc_lambda * costA + (1.0 - cfg.mc_lambda) * maha
        # threshold clamp (strongsort.cpp:374-377)
        costA = torch.where(costA > cfg.max_cos_dist, cfg.max_cos_dist + 1e-5,
                            costA)
        r2cA, c2rA = solve_lap_masked(costA, confirmed, valid,
                                      cfg.max_cos_dist, impl=cfg.lap_impl)
        mA = r2cA >= 0

        # --- stage B: IoU on tentative + just-missed confirmed -----------
        rowsB = tentative | (confirmed & ~mA & (tsu == 1))
        colsB = valid & (c2rA < 0)
        costB = 1.0 - iou_batch(boxes.xyah2xyxy(mean[..., :4]), det_xyxy)
        costB = torch.where((tsu > 1)[..., None], INFTY_COST, costB)
        r2cB, c2rB = solve_lap_masked(costB, rowsB, colsB, cfg.max_iou_dist,
                                      impl=cfg.lap_impl)
        mB = r2cB >= 0

        match = torch.where(mA, r2cA, torch.where(mB, r2cB, -1))
        m = match >= 0
        j = match.clamp(0, N - 1)

        # --- Track.update (strongsort.cpp:147-187) -----------------------
        drow = gather_rows(dets, j)
        umean, ucov = kf_xyah.update(mean, cov, gather_rows(det_xyah, j),
                                     nsa_conf=drow[..., 4])
        mean = torch.where(m[..., None], umean, mean)
        cov = torch.where(m[..., None, None], ucov, cov)
        conf = torch.where(m, drow[..., 4], state.conf)
        cls = torch.where(m, drow[..., 5], state.cls)
        det_ind = torch.where(m, j, state.det_ind)
        hits = torch.where(m, state.hits + 1, state.hits)
        tsu = torch.where(m, 0, tsu)

        # smoothed feature (EMA)
        dfeat = gather_rows(det_feat_n, j)
        dgood = det_has_feat.gather(1, j.long())
        smoothed, _ = _unit_rows(cfg.ema_alpha * state.feat
                                 + (1.0 - cfg.ema_alpha) * dfeat)
        new_feat = torch.where(state.has_feat[..., None], smoothed, dfeat)
        upd_feat = m & dgood
        feat = torch.where(upd_feat[..., None], new_feat, state.feat)
        has_feat = state.has_feat | upd_feat

        sstate = torch.where(m & tentative & (hits >= cfg.n_init), CONFIRMED,
                             state.sstate)

        # --- mark_missed (strongsort.cpp:189-195) ------------------------
        missed = occupied & ~m
        sstate = torch.where(missed & tentative, FREE, sstate)
        sstate = torch.where(missed & confirmed & (tsu > cfg.max_age), FREE,
                             sstate)

        # --- births: tentative, hits 1, age 1 (strongsort.cpp:46-91) -----
        u_det = valid & (c2rA < 0) & (c2rB < 0)
        free = sstate == FREE
        births, bdet, slot_rank = birth_slots(free, u_det)
        brow = gather_rows(dets, bdet)
        bmean, bcov = kf_xyah.initiate(gather_rows(det_xyah, bdet))
        mean = torch.where(births[..., None], bmean, mean)
        cov = torch.where(births[..., None, None], bcov, cov)
        conf = torch.where(births, brow[..., 4], conf)
        cls = torch.where(births, brow[..., 5], cls)
        det_ind = torch.where(births, bdet, det_ind)
        hits = torch.where(births, 1, hits)
        age = torch.where(births, 1, age)
        tsu = torch.where(births, 0, tsu)
        sstate = torch.where(births, TENTATIVE, sstate)
        feat = torch.where(births[..., None], gather_rows(det_feat_n, bdet),
                           feat)
        has_feat = torch.where(births, det_has_feat.gather(1, bdet.long()),
                               has_feat)
        tid = torch.where(births, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            u_det.sum(1, dtype=torch.int32), free.sum(1, dtype=torch.int32))

        # --- gallery partial_fit (strongsort.cpp:639-661, 213-238): every
        #     confirmed track appends its smoothed feature; reborn slots
        #     reset their ring first ---------------------------------------
        gallery = torch.where(births[..., None, None], 0.0, state.gallery)
        gallery_count = torch.where(births, 0, state.gallery_count)
        appending = (sstate == CONFIRMED) & has_feat
        slot = (gallery_count % B).long()
        written = torch.where(appending[..., None], feat,
                              take_slot(gallery, slot))
        # one row per (stream, slot) into the ring this step owns
        gallery.scatter_(2, slot[..., None, None].expand(S, K, 1, D),
                         written[:, :, None, :])
        gallery_count = torch.where(appending, gallery_count + 1,
                                    gallery_count)

        # --- output (strongsort.cpp:982-1002) ----------------------------
        out_mask = (sstate == CONFIRMED) & (tsu < 1)
        out = torch.cat(
            [boxes.xyah2xyxy(mean[..., :4]), tid[..., None].to(torch.float32),
             conf[..., None], cls[..., None],
             det_ind[..., None].to(torch.float32)],
            dim=-1,
        )
        new_state = StrongSortState(
            mean=mean, cov=cov, sstate=sstate, tid=tid, conf=conf, cls=cls,
            det_ind=det_ind, hits=hits, age=age, tsu=tsu, feat=feat,
            has_feat=has_feat, gallery=gallery, gallery_count=gallery_count,
            next_id=next_id, frame_count=frame,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("strongsort")
class StrongSORT(BaseTrackerWrapper):
    """Host-facing StrongSORT (reference: strongsort.hpp:305-324). With
    ``reid_weights`` and no embeddings given, features are computed from
    ``img`` by the port's ReID backend on ``device``; the host ECC warps
    every frame once a track exists."""

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
        min_conf: float = 0.1,
        max_cos_dist: float = 0.2,
        max_iou_dist: float = 0.7,
        n_init: int = 3,
        nn_budget: int = 100,
        mc_lambda: float = 0.98,
        ema_alpha: float = 0.9,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        emb_dim: int = 1,
        gallery_cap: int = 100,
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
            min_conf=min_conf,
            max_cos_dist=max_cos_dist,
            max_iou_dist=max_iou_dist,
            n_init=n_init,
            nn_budget=nn_budget,
            mc_lambda=mc_lambda,
            ema_alpha=ema_alpha,
            gallery_cap=gallery_cap,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self.reid_weights = reid_weights
        self._reid = None
        self._cmc = None
        self._build(emb_dim)

    def _build(self, emb_dim: int):
        self.cfg = StrongSortConfig(**self._cfg_kw, emb_dim=emb_dim)
        self._init, self._core_step = make_strongsort(self.cfg,
                                                      device=self.device)

    def update(self, dets, img=None, embs=None, warp=None):
        embs_arr = None if embs is None else np.asarray(embs, np.float32)
        if (embs_arr is not None and embs_arr.size > 0
                and embs_arr.shape[1] != self.cfg.emb_dim):
            self.emb_dim = embs_arr.shape[1]
            self._build(embs_arr.shape[1])
            self._state = None
        if ((embs_arr is None or embs_arr.size == 0) and self.reid_weights
                and img is not None and np.asarray(dets).shape[0] > 0):
            embs_arr = self._reid_features(np.asarray(dets, np.float32), img)
            if embs_arr.shape[1] != self.cfg.emb_dim:
                self.emb_dim = embs_arr.shape[1]
                self._build(embs_arr.shape[1])
        return super().update(dets, img, embs_arr, warp=warp)

    def _compute_warp(self, img, dets):
        # ECC on every frame once tracks exist (strongsort.cpp:915-921)
        if img is None or self._state is None:
            return None
        if not bool((self._state.sstate != FREE).any()):
            return None
        if self._cmc is None:
            from motcpp_tpu_torch.motion.cmc import ECC

            self._cmc = ECC()
        return self._cmc.apply(img, dets)

    def _reid_features(self, dets, img):
        if self._reid is None:
            from motcpp_tpu_torch.appearance.reid import ReIDBackend

            self._reid = ReIDBackend(self.reid_weights, device=self.device)
        return self._reid.get_features(dets[:, :4], img)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask, embs, warp=warp)
