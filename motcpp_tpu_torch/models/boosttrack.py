"""BoostTrack: confidence boosting and one fused Mahalanobis, IoU and
embedding cost, batched over streams.

Counterpart of ``motcpp_tpu/models/boosttrack.py``; its module doc lists
the reference behaviours this step replicates (reference:
src/trackers/boosttrack.cpp:14-699). Every tensor of the state has a
leading stream dimension S, and one call of the step advances all S
streams by one frame:

  * the camera-motion warp of every active track's corners, in the
    streams whose frame has a detection (boosttrack.cpp:486-495);
  * the private [x, y, h, r] Kalman predict (8D state, fixed Q and R);
  * the DLO, soft and visual-track confidence boosts
    (boosttrack.cpp:361-426);
  * one assignment over S problems on (1 - IoU) - lambda_mhd * MhSim
    [- lambda_emb * EmbSim under ``with_reid``];
  * the plain Kalman update, the embedding EMA, births, and the output
    filtered by aspect ratio and area (boosttrack.cpp:434-463, 663-698).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from motcpp_tpu_torch.device import PerDevice, resolve_device
from motcpp_tpu_torch.models import register
from motcpp_tpu_torch.models.base import BaseTrackerWrapper
from motcpp_tpu_torch.ops import select
from motcpp_tpu_torch.ops.boxes import warp_corners
from motcpp_tpu_torch.ops.iou import iou_batch
from motcpp_tpu_torch.ops.lap import solve_lap_masked
from motcpp_tpu_torch.ops.linalg import matmul_small, solve_spd

MH_LIMIT = 13.2767  # 99% chi2, 4 dof (boosttrack.cpp:600)

# the constant Kalman matrices' diagonals (boosttrack.cpp:27-53)
_Q_DIAG = [10.0] * 4 + [0.01] * 4
_R_DIAG = [1.0, 1.0, 10.0, 0.01]
_P0_DIAG = [10.0] * 4 + [10000.0] * 4


@dataclasses.dataclass(frozen=True)
class BoostTrackConfig:
    """Reference defaults: boosttrack.hpp:96-125."""

    det_thresh: float = 0.6
    max_age: int = 60
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    use_ecc: bool = True
    min_box_area: int = 10
    aspect_ratio_thresh: float = 1.6
    lambda_iou: float = 0.5
    lambda_mhd: float = 0.25
    lambda_shape: float = 0.25
    use_dlo_boost: bool = True
    use_duo_boost: bool = True
    dlo_boost_coef: float = 0.65
    s_sim_corr: bool = False
    use_rich_s: bool = False
    use_sb: bool = False
    use_vt: bool = False
    with_reid: bool = False
    emb_dim: int = 1
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"


class BoostState(NamedTuple):
    x: torch.Tensor  # (S, K, 8) [x, y, h, r, vx, vy, vh, vr]
    P: torch.Tensor  # (S, K, 8, 8)
    active: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32, emitted as is
    conf: torch.Tensor
    cls: torch.Tensor
    det_ind: torch.Tensor
    age: torch.Tensor
    tsu: torch.Tensor
    hit_streak: torch.Tensor
    emb: torch.Tensor  # (S, K, D)
    has_emb: torch.Tensor  # (S, K) bool
    next_id: torch.Tensor  # (S,)
    frame_count: torch.Tensor  # (S,)


def _bbox_to_z(xyxy):
    """xyxy -> [cx, cy, h, r = w / h] (boosttrack.cpp:127-134)."""
    w = xyxy[..., 2] - xyxy[..., 0]
    h = xyxy[..., 3] - xyxy[..., 1]
    cx = xyxy[..., 0] + w * 0.5
    cy = xyxy[..., 1] + h * 0.5
    r = torch.where(h > 1e-6, w / torch.where(h > 1e-6, h, 1.0), 0.0)
    return torch.stack([cx, cy, h, r], dim=-1)


def _z_to_bbox(x):
    """state[:4] -> xyxy (boosttrack.cpp:107-115)."""
    cx, cy, h, r = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    w = r * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _kf_predict(x, P, Q):
    """x <- F x, P <- F P F' + Q with F = [[I, I], [0, I]] (4x4 blocks):
    F P F' as block sums, no 8x8 products."""
    new_x = torch.cat([x[..., :4] + x[..., 4:], x[..., 4:]], dim=-1)
    A = P[..., :4, :4]
    B = P[..., :4, 4:]
    C = P[..., 4:, :4]
    Dm = P[..., 4:, 4:]
    top = torch.cat([A + B + C + Dm, B + Dm], dim=-1)
    bot = torch.cat([C + Dm, Dm], dim=-1)
    return new_x, torch.cat([top, bot], dim=-2) + Q


def _kf_update(x, P, z, R):
    """The plain P - K S K' update (boosttrack.cpp:84-100) with the
    closed-form 4x4 solve and unrolled products."""
    S = P[..., :4, :4] + R
    PHt = P[..., :, :4]
    Kg = solve_spd(S, PHt.transpose(-1, -2)).transpose(-1, -2)
    prod = Kg * (z - x[..., :4])[..., None, :]
    corr = prod[..., 0]
    for i in range(1, 4):
        corr = corr + prod[..., i]
    KS = matmul_small(Kg, S)
    return x + corr, P - matmul_small(KS, Kg.transpose(-1, -2))


def make_boosttrack(cfg: BoostTrackConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> BoostState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N), embs (S, N, D) or
    None, warp (S, 2, 3) or None) -> (state, (out (S, K, 8),
    out_mask (S, K)))``."""
    K = cfg.max_tracks
    D = cfg.emb_dim
    dev = resolve_device(device)
    P0 = torch.diag(torch.tensor(_P0_DIAG, device=dev))
    # the step's constants on the device of its inputs
    consts = PerDevice.tensors(dev, torch.diag(torch.tensor(_Q_DIAG,
                                                            device=dev)),
                               torch.diag(torch.tensor(_R_DIAG, device=dev)),
                               P0)

    def init_fn(n_streams: int = 1) -> BoostState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        return BoostState(
            x=zeros(K, 8, dtype=torch.float32),
            P=P0.expand(S, K, 8, 8).clone(),
            active=zeros(K, dtype=torch.bool),
            tid=zeros(K),
            conf=zeros(K, dtype=torch.float32),
            cls=zeros(K, dtype=torch.float32),
            det_ind=torch.full((S, K), -1, dtype=torch.int32, device=dev),
            age=zeros(K),
            tsu=zeros(K),
            hit_streak=zeros(K),
            emb=torch.ones((S, K, D), device=dev),
            has_emb=zeros(K, dtype=torch.bool),
            next_id=zeros(),
            frame_count=zeros(),
        )

    def step_fn(state: BoostState, dets, det_mask, embs=None, warp=None):
        S, N = det_mask.shape
        Q, R, P0 = consts.on(dets.device)
        frame = state.frame_count + 1
        det_xyxy = dets[..., :4]
        active = state.active
        x, P = state.x, state.P

        # --- camera motion before the predict, in the streams with a
        #     detection this frame (boosttrack.cpp:486-495) --------------
        if warp is not None:
            p1, p2 = warp_corners(_z_to_bbox(x), warp)
            new_z = _bbox_to_z(torch.cat([p1, p2], dim=-1))
            apply = active & det_mask.any(-1)[:, None]
            x = torch.where(apply[..., None],
                            torch.cat([new_z, x[..., 4:]], dim=-1), x)

        # --- predict (boosttrack.cpp:156-163, 497-514) ---------------------
        px, pP = _kf_predict(x, P, Q)
        x = torch.where(active[..., None], px, x)
        P = torch.where(active[..., None, None], pP, P)
        age = torch.where(active, state.age + 1, state.age)
        hit_streak = torch.where(active & (state.tsu > 0), 0,
                                 state.hit_streak)
        tsu = torch.where(active, state.tsu + 1, state.tsu)
        trk_xyxy = _z_to_bbox(x)

        # --- confidence boosting (boosttrack.cpp:361-426) ------------------
        det_conf = dets[..., 4]
        iou = iou_batch(det_xyxy, trk_xyxy)  # (S, N, K)
        sim = torch.where(det_mask[..., :, None] & active[..., None, :], iou,
                          0.0)
        any_trk = active.any(-1)[:, None]
        if cfg.use_dlo_boost:
            max_s = sim.amax(-1)
            if not cfg.use_sb and not cfg.use_vt:
                det_conf = torch.where(
                    any_trk, torch.maximum(det_conf,
                                           max_s * cfg.dlo_boost_coef),
                    det_conf)
            else:
                if cfg.use_sb:
                    alpha = 0.65
                    boosted = alpha * det_conf + (1 - alpha) * max_s ** 1.5
                    det_conf = torch.where(
                        any_trk, torch.maximum(det_conf, boosted), det_conf)
                if cfg.use_vt:
                    # the threshold decays with each track's (tsu - 1)
                    thr = torch.clamp_min(
                        0.95 - (tsu - 1).to(torch.float32), 0.8)[..., None, :]
                    hit = ((sim > thr) & active[..., None, :]).any(-1)
                    det_conf = torch.where(
                        any_trk & hit,
                        torch.clamp_min(det_conf, cfg.det_thresh + 1e-5),
                        det_conf)
        # the DUO boost is a stub in the reference

        valid = det_mask & (det_conf >= cfg.det_thresh)
        if embs is None:
            dets_emb = torch.ones((S, N, D), device=dets.device)
            det_has_emb = torch.zeros_like(det_mask)
        else:
            dets_emb = embs[..., :D]
            n = torch.linalg.vector_norm(dets_emb, dim=-1, keepdim=True)
            det_has_emb = valid & (n[..., 0] > 0)
            dets_emb = dets_emb / torch.where(n > 0, n, 1.0)

        # --- one fused cost (boosttrack.cpp:571-624) -----------------------
        iou_d = 1.0 - iou
        z_det = _bbox_to_z(det_xyxy)
        diff = z_det[..., :, None, :] - x[..., None, :, :4]  # (S, N, K, 4)
        sigma_inv = 1.0 / torch.diagonal(P[..., :4, :4], dim1=-2, dim2=-1)
        terms = diff ** 2 * sigma_inv[..., None, :, :]
        maha = terms[..., 0]
        for i in range(1, 4):
            maha = maha + terms[..., i]
        mh_sim = (MH_LIMIT - torch.clamp_max(maha, MH_LIMIT)) / MH_LIMIT
        cost = iou_d - cfg.lambda_mhd * mh_sim
        if cfg.with_reid:
            lambda_emb = (1.0 + cfg.lambda_iou + cfg.lambda_shape
                          + cfg.lambda_mhd) * 1.5
            # float32 products (TF32 stays off)
            emb_sim = (torch.matmul(dets_emb, state.emb.transpose(-1, -2))
                       + 1.0) / 2.0
            emb_sim = torch.where(
                det_has_emb[..., :, None] & state.has_emb[..., None, :],
                emb_sim, 0.5)
            cost = cost - lambda_emb * emb_sim
        d2t, t2d = solve_lap_masked(cost, valid, active, cfg.iou_threshold,
                                    impl=cfg.lap_impl)
        m = t2d >= 0
        j = t2d.clamp(0, N - 1)

        # --- matched updates (boosttrack.cpp:637-650) ----------------------
        jl = j.long()
        drow_conf = det_conf.gather(1, jl)
        ux, uP = _kf_update(x, P, _bbox_to_z(select.gather_rows(det_xyxy, j)),
                            R)
        x = torch.where(m[..., None], ux, x)
        P = torch.where(m[..., None, None], uP, P)
        conf = torch.where(m, drow_conf, state.conf)
        cls = torch.where(m, dets[..., 5].gather(1, jl), state.cls)
        det_ind = torch.where(m, j, state.det_ind)
        tsu = torch.where(m, 0, tsu)
        hit_streak = torch.where(m, hit_streak + 1, hit_streak)

        trust = (drow_conf - cfg.det_thresh) / (1.0 - cfg.det_thresh)
        af = 0.95
        alpha_d = af + (1.0 - af) * (1.0 - trust)
        demb = select.gather_rows(dets_emb, j)
        new_emb = (alpha_d[..., None] * state.emb
                   + (1 - alpha_d)[..., None] * demb)
        nrm = torch.linalg.vector_norm(new_emb, dim=-1, keepdim=True)
        new_emb = new_emb / torch.where(nrm > 0, nrm, 1.0)
        upd_e = m & det_has_emb.gather(1, jl)
        emb = torch.where(
            upd_e[..., None],
            torch.where(state.has_emb[..., None], new_emb, demb), state.emb)
        has_emb = state.has_emb | upd_e

        # --- births ------------------------------------------------------
        u_det = valid & (d2t < 0)
        free = ~active
        births, bdet, slot_rank = select.birth_slots(free, u_det)
        bl = bdet.long()
        bz = _bbox_to_z(select.gather_rows(det_xyxy, bdet))
        b1, b3 = births[..., None], births
        x = torch.where(b1, torch.cat([bz, torch.zeros_like(bz)], dim=-1), x)
        P = torch.where(births[..., None, None], P0, P)
        conf = torch.where(b3, det_conf.gather(1, bl), conf)
        cls = torch.where(b3, dets[..., 5].gather(1, bl), cls)
        det_ind = torch.where(b3, bdet, det_ind)
        age = torch.where(b3, 0, age)
        tsu = torch.where(b3, 0, tsu)
        hit_streak = torch.where(b3, 0, hit_streak)
        emb = torch.where(b1, select.gather_rows(dets_emb, bdet), emb)
        has_emb = torch.where(b3, det_has_emb.gather(1, bl), has_emb)
        tid = torch.where(b3, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            u_det.sum(1, dtype=torch.int32), free.sum(1, dtype=torch.int32))
        active = active | births

        # --- output with box filtering (boosttrack.cpp:434-463, 663-698) -
        out_xyxy = _z_to_bbox(x)
        w = out_xyxy[..., 2] - out_xyxy[..., 0]
        h = out_xyxy[..., 3] - out_xyxy[..., 1]
        shape_ok = ((w / (h + 1e-6) <= cfg.aspect_ratio_thresh)
                    & (w * h > cfg.min_box_area))
        out_mask = (active & (tsu < 1)
                    & ((hit_streak >= cfg.min_hits)
                       | (frame <= cfg.min_hits)[:, None])
                    & shape_ok)
        out = torch.cat(
            [out_xyxy, tid[..., None].to(torch.float32), conf[..., None],
             cls[..., None], det_ind[..., None].to(torch.float32)],
            dim=-1,
        )

        active = active & (tsu <= cfg.max_age)

        new_state = BoostState(
            x=x, P=P, active=active, tid=tid, conf=conf, cls=cls,
            det_ind=det_ind, age=age, tsu=tsu, hit_streak=hit_streak,
            emb=emb, has_emb=has_emb, next_id=next_id, frame_count=frame,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("boosttrack")
class BoostTrack(BaseTrackerWrapper):
    """Host-facing BoostTrack (reference: boosttrack.hpp:96-127). The
    host ECC warps every frame that has a detection, while ``use_ecc``."""

    def __init__(
        self,
        reid_weights: str = "",
        use_half: bool = False,
        use_gpu: bool = False,
        det_thresh: float = 0.6,
        max_age: int = 60,
        max_obs: int = 50,
        min_hits: int = 3,
        iou_threshold: float = 0.3,
        per_class: bool = False,
        nr_classes: int = 80,
        asso_func: str = "iou",
        is_obb: bool = False,
        use_ecc: bool = True,
        min_box_area: int = 10,
        aspect_ratio_thresh: float = 1.6,
        cmc_method: str = "ecc",
        lambda_iou: float = 0.5,
        lambda_mhd: float = 0.25,
        lambda_shape: float = 0.25,
        use_dlo_boost: bool = True,
        use_duo_boost: bool = True,
        dlo_boost_coef: float = 0.65,
        s_sim_corr: bool = False,
        use_rich_s: bool = False,
        use_sb: bool = False,
        use_vt: bool = False,
        with_reid: bool = False,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        emb_dim: int = 1,
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, emb_dim=emb_dim, device=device)
        # accepted for the reference's constructor signature; unused
        del per_class, nr_classes, asso_func, is_obb, use_half, use_gpu
        del cmc_method
        self._cfg_kw = dict(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            use_ecc=use_ecc,
            min_box_area=min_box_area,
            aspect_ratio_thresh=aspect_ratio_thresh,
            lambda_iou=lambda_iou,
            lambda_mhd=lambda_mhd,
            lambda_shape=lambda_shape,
            use_dlo_boost=use_dlo_boost,
            use_duo_boost=use_duo_boost,
            dlo_boost_coef=dlo_boost_coef,
            s_sim_corr=s_sim_corr,
            use_rich_s=use_rich_s,
            use_sb=use_sb,
            use_vt=use_vt,
            with_reid=with_reid,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self.reid_weights = reid_weights
        self._cmc = None
        self._build(emb_dim)

    def _build(self, emb_dim: int):
        self.cfg = BoostTrackConfig(**self._cfg_kw, emb_dim=emb_dim)
        self._init, self._core_step = make_boosttrack(self.cfg,
                                                      device=self.device)

    def update(self, dets, img=None, embs=None, warp=None):
        embs_arr = None if embs is None else np.asarray(embs, np.float32)
        if (embs_arr is not None and embs_arr.size > 0
                and embs_arr.shape[1] != self.cfg.emb_dim):
            self.emb_dim = embs_arr.shape[1]
            self._build(embs_arr.shape[1])
            self._state = None
        return super().update(dets, img, embs_arr, warp=warp)

    def _compute_warp(self, img, dets):
        # ECC while enabled, on frames with detections (boosttrack.cpp:486-495)
        if not self.cfg.use_ecc or img is None or dets.shape[0] == 0:
            return None
        if self._cmc is None:
            from motcpp_tpu_torch.motion.cmc import ECC

            self._cmc = ECC()
        return self._cmc.apply(img, dets)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask, embs, warp=warp)
