"""DeepOC-SORT: OC-SORT with appearance, batched over streams.

Counterpart of ``motcpp_tpu/models/deepocsort.py``; its module doc lists
the reference behaviours this step replicates (reference:
src/trackers/deepocsort.cpp:50-944). It builds on the OC-SORT step
(``models/ocsort.py``: the observation ring, the velocity-direction
cost, the gated OCR rematch) and adds, for every stream at once:

  * per-track EMA embeddings with a per-detection dynamic alpha,
    renormalised after every step (deepocsort.cpp:143-161, 650-653);
  * stage 1 on ``-(IoU + angle + emb)``, the embedding term zeroed where
    IoU <= 0 and scaled by the adaptive top-2-gap weight
    (:func:`compute_aw_max_metric`) unless ``aw_off``;
  * the camera-motion affine applied to every active track's state
    before the predict, unless ``cmc_off`` or the warp is None;
  * the OCR rematch on plain IoU; no low-confidence stage;
  * output ids without OC-SORT's +1 (deepocsort.cpp:913).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.models import register
from motcpp_tpu_torch.models.base import BaseTrackerWrapper
from motcpp_tpu_torch.models.ocsort import (
    _NO_AGE,
    _angle_cost,
    _filter_by_iou,
    _gated_greedy_or_lap,
    _gated_rematch,
    _k_previous_obs,
    _observe,
)
from motcpp_tpu_torch.ops import boxes, select
from motcpp_tpu_torch.ops.iou import get_asso_fn
from motcpp_tpu_torch.ops.kalman.xysr import (
    DIM_X,
    XYSRParams,
    xysr_apply_affine,
    xysr_init,
    xysr_predict,
)
from motcpp_tpu_torch.ops.lap import solve_lap_masked


@dataclasses.dataclass(frozen=True)
class DeepOCSortConfig:
    """Reference defaults (deepocsort.cpp:507-541, deepocsort.yaml)."""

    det_thresh: float = 0.3
    max_age: int = 30
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    asso_func: str = "iou"
    delta_t: int = 3
    inertia: float = 0.2
    w_association_emb: float = 0.5
    alpha_fixed_emb: float = 0.95
    aw_param: float = 0.5
    embedding_off: bool = False
    cmc_off: bool = False
    aw_off: bool = False
    q_xy_scaling: float = 0.01
    q_s_scaling: float = 0.0001
    emb_dim: int = 1
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"
    frame_width: int = 1920
    frame_height: int = 1080

    @property
    def ring(self) -> int:
        return self.delta_t + 2


class DeepOCState(NamedTuple):
    x: torch.Tensor  # (S, K, 7)
    P: torch.Tensor  # (S, K, 7, 7)
    active: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32, emitted as is
    age: torch.Tensor
    hits: torch.Tensor
    hit_streak: torch.Tensor
    tsu: torch.Tensor
    conf: torch.Tensor
    cls: torch.Tensor
    det_ind: torch.Tensor
    last_obs: torch.Tensor  # (S, K, 5)
    velocity: torch.Tensor  # (S, K, 2)
    obs_ring: torch.Tensor  # (S, K, R, 5)
    obs_age: torch.Tensor  # (S, K, R)
    obs_ptr: torch.Tensor
    emb: torch.Tensor  # (S, K, D) L2-normalised EMA appearance
    next_id: torch.Tensor  # (S,)
    frame_count: torch.Tensor  # (S,)


def compute_aw_max_metric(emb_cost, row_mask, col_mask, w_assoc_emb, bottom):
    """Adaptive embedding weight from the top-2 gap per row and column
    (reference: deepocsort.cpp:294-348), mask-aware: masked pairs count
    as -inf, and a line with fewer than two candidates keeps the full
    weight. emb_cost (..., N, K), row_mask (..., N), col_mask (..., K)."""
    valid = row_mask[..., :, None] & col_mask[..., None, :]
    e = torch.where(valid, emb_cost, -torch.inf)

    def weights(mat, count):
        mx = mat.amax(-1)
        arg = mat.argmax(-1)
        hit = arg[..., None] == torch.arange(mat.shape[-1],
                                             device=mat.device)
        second = torch.where(hit, -torch.inf, mat).amax(-1)
        finite_mx = torch.isfinite(mx)
        safe_mx = torch.where((mx != 0.0) & finite_mx, mx, 1.0)
        ratio = torch.where(torch.isfinite(second), second / safe_mx, 0.0)
        w = 1.0 - (ratio - bottom).clamp_min(0.0) / (1.0 - bottom)
        w = torch.where(mx == 0.0, 0.0, w)
        w = torch.where(finite_mx, w, 0.0)  # a fully masked line
        return torch.where(count[..., None] < 2, 1.0, w)

    n_cols = col_mask.sum(-1)
    n_rows = row_mask.sum(-1)
    w_row = weights(e, n_cols)  # (..., N)
    w_col = weights(e.transpose(-1, -2), n_rows)  # (..., K)
    w = w_assoc_emb * w_row[..., :, None] * w_col[..., None, :]
    return w * torch.where(valid, emb_cost, 0.0)


def make_deepocsort(cfg: DeepOCSortConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> DeepOCState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N), embs (S, N, D) or
    None, warp (S, 2, 3) or None) -> (state, (out (S, K, 8),
    out_mask (S, K)))``."""
    K = cfg.max_tracks
    R = cfg.ring
    D = cfg.emb_dim
    dev = resolve_device(device)
    kf = XYSRParams(q_xy_scaling=cfg.q_xy_scaling,
                    q_s_scaling=cfg.q_s_scaling)
    asso = get_asso_fn(cfg.asso_func, cfg.frame_width, cfg.frame_height)

    def init_fn(n_streams: int = 1) -> DeepOCState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        def full(shape, value, dtype=torch.float32):
            return torch.full((S,) + shape, value, dtype=dtype, device=dev)

        return DeepOCState(
            x=zeros(K, DIM_X, dtype=torch.float32),
            P=torch.eye(DIM_X, device=dev).expand(S, K, DIM_X, DIM_X).clone(),
            active=zeros(K, dtype=torch.bool),
            tid=zeros(K),
            age=zeros(K),
            hits=zeros(K),
            hit_streak=zeros(K),
            tsu=zeros(K),
            conf=zeros(K, dtype=torch.float32),
            cls=zeros(K, dtype=torch.float32),
            det_ind=full((K,), -1, torch.int32),
            last_obs=full((K, 5), -1.0),
            velocity=zeros(K, 2, dtype=torch.float32),
            obs_ring=full((K, R, 5), -1.0),
            obs_age=full((K, R), _NO_AGE, torch.int32),
            obs_ptr=zeros(K),
            emb=full((K, D), 1.0),
            next_id=zeros(),
            frame_count=zeros(),
        )

    def step_fn(state: DeepOCState, dets, det_mask, embs=None, warp=None):
        S, N = det_mask.shape
        frame = state.frame_count + 1
        det_conf = dets[..., 4]
        det_xyxy = dets[..., :4]

        high = det_mask & (det_conf > cfg.det_thresh)
        if cfg.embedding_off or embs is None:
            dets_emb = torch.ones((S, N, D), device=dets.device)
        else:
            dets_emb = embs[..., :D]

        # dynamic EMA alpha (deepocsort.cpp:650-653)
        trust = (det_conf - cfg.det_thresh) / (1.0 - cfg.det_thresh)
        dets_alpha = cfg.alpha_fixed_emb + (1.0 - cfg.alpha_fixed_emb) * (
            1.0 - trust)

        # --- camera motion before the predict (deepocsort.cpp:637-648) --
        act = state.active
        x, P = state.x, state.P
        if not cfg.cmc_off and warp is not None:
            wx, wP = xysr_apply_affine(x, P, warp[:, None, :, :2],
                                       warp[:, None, :, 2])
            x = torch.where(act[..., None], wx, x)
            P = torch.where(act[..., None, None], wP, P)

        # --- predict, scale velocity clamped ------------------------------
        clamp = (x[..., 6] + x[..., 2]) <= 0
        x = torch.cat([x[..., :6],
                       torch.where(clamp, 0.0, x[..., 6])[..., None]], dim=-1)
        px, pP = xysr_predict(x, P, kf)
        x = torch.where(act[..., None], px, x)
        P = torch.where(act[..., None, None], pP, P)
        age = torch.where(act, state.age + 1, state.age)
        hit_streak = torch.where(act & (state.tsu > 0), 0, state.hit_streak)
        tsu = torch.where(act, state.tsu + 1, state.tsu)

        trk_xyxy = boxes.xysr2xyxy(x[..., :4])
        active = act & torch.isfinite(trk_xyxy).all(-1)
        had_tracks = active.any(-1)

        # --- stage 1: IoU + angle + adaptive embedding --------------------
        k_obs = _k_previous_obs(state.obs_ring, state.obs_age, age,
                                cfg.delta_t)
        iou_mat = asso(det_xyxy, trk_xyxy)  # (S, N, K)
        angle_cost = _angle_cost(det_xyxy, det_conf, k_obs, state.velocity,
                                 cfg.inertia)
        # cosine of unit vectors; float32 products (TF32 stays off)
        emb_raw = torch.matmul(dets_emb, state.emb.transpose(-1, -2))
        emb_raw = torch.where(iou_mat <= 0.0, 0.0, emb_raw)
        if cfg.embedding_off:
            emb_cost = torch.zeros_like(emb_raw)
        elif cfg.aw_off:
            emb_cost = torch.where(high[..., :, None] & active[..., None, :],
                                   emb_raw, 0.0) * cfg.w_association_emb
        else:
            emb_cost = compute_aw_max_metric(emb_raw, high, active,
                                             cfg.w_association_emb,
                                             cfg.aw_param)

        trivial, d2t_trivial = _gated_greedy_or_lap(iou_mat, high, active,
                                                    cfg.iou_threshold)
        d2t_lap, _ = solve_lap_masked(-(iou_mat + angle_cost + emb_cost),
                                      high, active, -cfg.iou_threshold,
                                      impl=cfg.lap_impl)
        d2t_lap = _filter_by_iou(d2t_lap, iou_mat, cfg.iou_threshold)
        d2t = torch.where(trivial[:, None], d2t_trivial, d2t_lap)
        t2d = select.invert_matching(d2t, K)
        u_trk = active & (t2d < 0)
        u_det = high & (d2t < 0)

        # --- OCR rematch on plain IoU (deepocsort.cpp:800-876); last_obs
        #     is unchanged on every unmatched column, and both stages'
        #     updates merge into one --------------------------------------
        iou3 = asso(det_xyxy, state.last_obs[..., :4])
        d2t_3, t2d_3 = _gated_rematch(iou3, -iou3, u_det, u_trk,
                                      cfg.iou_threshold, -cfg.iou_threshold,
                                      cfg.lap_impl)
        t2d_all = torch.where(t2d >= 0, t2d, t2d_3)
        v = dict(x=x, P=P, conf=state.conf, cls=state.cls,
                 det_ind=state.det_ind, last_obs=state.last_obs,
                 velocity=state.velocity, obs_ring=state.obs_ring,
                 obs_age=state.obs_age, obs_ptr=state.obs_ptr, tsu=tsu,
                 hits=state.hits, hit_streak=hit_streak)
        _observe(v, t2d_all, dets, age, cfg.delta_t, kf)

        # EMA and renormalisation (deepocsort.cpp:143-161)
        m = t2d_all >= 0
        j = t2d_all.clamp(0, N - 1)
        alpha = dets_alpha.gather(1, j.long())[..., None]
        new_emb = alpha * state.emb + (1.0 - alpha) * select.gather_rows(
            dets_emb, j)
        norm = torch.linalg.vector_norm(new_emb, dim=-1, keepdim=True)
        new_emb = new_emb / torch.where(norm > 0, norm, 1.0)
        emb = torch.where(m[..., None], new_emb, state.emb)
        u_trk = u_trk & (t2d_3 < 0)
        u_det = u_det & (d2t_3 < 0)

        # --- null update: det_ind = 0 (deepocsort.cpp:96-97) --------------
        det_ind = torch.where(u_trk, 0, v["det_ind"])

        # --- births ---------------------------------------------------------
        free = ~active
        births, bdet, slot_rank = select.birth_slots(free, u_det)
        brow = select.gather_rows(dets, bdet)
        bx, bP = xysr_init(boxes.xyxy2xysr(brow[..., :4]), kf)
        b1, b2, b3 = births[..., None], births[..., None, None], births
        x = torch.where(b1, bx, v["x"])
        P = torch.where(b2, bP, v["P"])
        conf = torch.where(b3, brow[..., 4], v["conf"])
        cls = torch.where(b3, brow[..., 5], v["cls"])
        det_ind = torch.where(b3, bdet, det_ind)
        age = torch.where(b3, 0, age)
        hits = torch.where(b3, 0, v["hits"])
        hit_streak = torch.where(b3, 0, v["hit_streak"])
        tsu = torch.where(b3, 0, v["tsu"])
        last_obs = torch.where(b1, -1.0, v["last_obs"])
        velocity = torch.where(b1, 0.0, v["velocity"])
        obs_ring = torch.where(b2, -1.0, v["obs_ring"])
        obs_age = torch.where(b1, _NO_AGE, v["obs_age"])
        obs_ptr = torch.where(b3, 0, v["obs_ptr"])
        emb = torch.where(b1, select.gather_rows(dets_emb, bdet), emb)
        tid = torch.where(b3, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            u_det.sum(1, dtype=torch.int32), free.sum(1, dtype=torch.int32))
        active = active | births

        # --- output, ids without +1 (deepocsort.cpp:913) -----------------
        obs_valid = last_obs[..., :4].sum(-1) >= 0
        out_box = torch.where(obs_valid[..., None], last_obs[..., :4],
                              boxes.xysr2xyxy(x[..., :4]))
        out_mask = (had_tracks[:, None] & active & (tsu < 1)
                    & ((hit_streak >= cfg.min_hits)
                       | (frame <= cfg.min_hits)[:, None]))
        out = torch.cat(
            [out_box, tid[..., None].to(torch.float32), conf[..., None],
             cls[..., None], det_ind[..., None].to(torch.float32)],
            dim=-1,
        )

        active = active & (tsu <= cfg.max_age)

        new_state = DeepOCState(
            x=x, P=P, active=active, tid=tid, age=age, hits=hits,
            hit_streak=hit_streak, tsu=tsu, conf=conf, cls=cls,
            det_ind=det_ind, last_obs=last_obs, velocity=velocity,
            obs_ring=obs_ring, obs_age=obs_age, obs_ptr=obs_ptr, emb=emb,
            next_id=next_id, frame_count=frame,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("deepocsort")
class DeepOCSort(BaseTrackerWrapper):
    """Host-facing DeepOC-SORT (reference: deepocsort.cpp:507-541).

    Embeddings come from ``update(dets, img, embs)`` or, with
    ``reid_weights`` and none given, from ``img`` through the port's
    ReID backend on ``device``. The camera-motion warp comes from the
    host sparse-flow estimator (``motion/cmc.py::SOF``) unless
    ``cmc_off``."""

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
        delta_t: int = 3,
        inertia: float = 0.2,
        w_association_emb: float = 0.5,
        alpha_fixed_emb: float = 0.95,
        aw_param: float = 0.5,
        embedding_off: bool = False,
        cmc_off: bool = False,
        aw_off: bool = False,
        Q_xy_scaling: float = 0.01,
        Q_s_scaling: float = 0.0001,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        emb_dim: int = 1,
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, emb_dim=emb_dim, device=device)
        # accepted for the reference's constructor signature; unused
        del per_class, nr_classes, is_obb, use_half, use_gpu
        self._cfg_kw = dict(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            asso_func=asso_func,
            delta_t=delta_t,
            inertia=inertia,
            w_association_emb=w_association_emb,
            alpha_fixed_emb=alpha_fixed_emb,
            aw_param=aw_param,
            embedding_off=embedding_off,
            cmc_off=cmc_off,
            aw_off=aw_off,
            q_xy_scaling=Q_xy_scaling,
            q_s_scaling=Q_s_scaling,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self.reid_weights = reid_weights
        self._reid = None
        self._cmc = None
        self._build(emb_dim)

    def _build(self, emb_dim: int):
        self.cfg = DeepOCSortConfig(**self._cfg_kw, emb_dim=emb_dim)
        self._init, self._core_step = make_deepocsort(self.cfg,
                                                      device=self.device)

    def update(self, dets, img=None, embs=None, warp=None):
        embs_arr = None if embs is None else np.asarray(embs, np.float32)
        if (embs_arr is not None and embs_arr.size > 0
                and embs_arr.shape[1] != self.cfg.emb_dim):
            # tracks restart with the new embedding width
            self.emb_dim = embs_arr.shape[1]
            self._build(embs_arr.shape[1])
            self._state = None
        if ((embs_arr is None or embs_arr.size == 0)
                and not self.cfg.embedding_off and self.reid_weights
                and img is not None and np.asarray(dets).shape[0] > 0):
            embs_arr = self._reid_features(np.asarray(dets, np.float32), img)
            if embs_arr.shape[1] != self.cfg.emb_dim:
                self.emb_dim = embs_arr.shape[1]
                self._build(embs_arr.shape[1])
        return super().update(dets, img, embs_arr, warp=warp)

    def _compute_warp(self, img, dets):
        if self.cfg.cmc_off or img is None or dets.shape[0] == 0:
            return None
        if self._cmc is None:
            from motcpp_tpu_torch.motion.cmc import SOF

            # deepocsort.cpp:553-556
            self._cmc = SOF(scale=0.15, device=self.device)
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
