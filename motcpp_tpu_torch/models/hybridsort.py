"""HybridSORT: a Kalman filter with the score in its state and TCM score
costs, batched over streams.

Counterpart of ``motcpp_tpu/models/hybridsort.py``; its module doc lists
the reference behaviours this step replicates, the reference's
simplifications included (reference: src/trackers/hybridsort.cpp:26-1258).
Every tensor of the state has a leading stream dimension S, and one call
of the step advances all S streams by one frame:

  * the camera-motion warp: [u, v, s, c, r] rebuilt from the warped
    corners and the velocities zeroed, in the streams whose frame has a
    detection (hybridsort.cpp:91-121);
  * the 9D predict, scale velocity clamped;
  * stage 1 on the high dets: (1 - HMIoU) [+ EG_high * emb_dist under
    ``with_reid``], with the long-term correction rescue;
  * the BYTE stage on the low dets, IoU minus the TCM score difference;
  * the final rematch of the leftover high dets against the tracks'
    last observations; three gated assignments over S problems;
  * one merged update (features on stage-1 matches only), the Kalman
    update of every unmatched track toward a zero measurement (the
    reference's quirk, hybridsort.cpp:322-328), births and the +1 output.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from motcpp_tpu_torch.device import PerDevice, resolve_device
from motcpp_tpu_torch.models import register
from motcpp_tpu_torch.models.base import BaseTrackerWrapper
from motcpp_tpu_torch.models.ocsort import _NO_AGE, _gated_rematch
from motcpp_tpu_torch.ops import select
from motcpp_tpu_torch.ops.boxes import warp_corners
from motcpp_tpu_torch.ops.iou import hmiou_batch, iou_batch
from motcpp_tpu_torch.ops.lap import solve_lap_masked
from motcpp_tpu_torch.ops.linalg import matmul_small, solve_spd

# the Kalman filter's constant diagonals (hybridsort.cpp:26-58)
_Q9_DIAG = [0.1, 0.1, 0.1, 0.1, 0.1, 0.01, 0.01, 0.01, 0.01]
_R5_DIAG = [1.0, 1.0, 10.0, 0.01, 1.0]
_P09_DIAG = [10.0] * 5 + [10000.0] * 4


@dataclasses.dataclass(frozen=True)
class HybridSortConfig:
    """Reference defaults: hybridsort.hpp:127-164."""

    det_thresh: float = 0.7
    max_age: int = 30
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.15
    asso_func: str = "hmiou"
    low_thresh: float = 0.1
    delta_t: int = 3
    inertia: float = 0.05
    use_byte: bool = True
    longterm_bank_length: int = 30
    alpha: float = 0.9
    adapfs: bool = False
    track_thresh: float = 0.5
    eg_weight_high_score: float = 4.6
    eg_weight_low_score: float = 1.3
    tcm_first_step: bool = True
    tcm_byte_step: bool = True
    tcm_byte_step_weight: float = 1.0
    high_score_matching_thresh: float = 0.7
    with_longterm_reid: bool = True
    longterm_reid_weight: float = 0.0
    with_longterm_reid_correction: bool = True
    longterm_reid_correction_thresh: float = 0.4
    longterm_reid_correction_thresh_low: float = 0.4
    with_reid: bool = True
    emb_dim: int = 1
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"

    @property
    def ring(self) -> int:
        return self.delta_t + 2


class HybridState(NamedTuple):
    x: torch.Tensor  # (S, K, 9) [u, v, s, c, r, du, dv, ds, dc]
    P: torch.Tensor  # (S, K, 9, 9)
    active: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32 (the output emits tid + 1)
    age: torch.Tensor
    hits: torch.Tensor
    hit_streak: torch.Tensor
    tsu: torch.Tensor
    conf: torch.Tensor
    conf_pre: torch.Tensor
    cls: torch.Tensor
    det_ind: torch.Tensor
    last_obs: torch.Tensor  # (S, K, 5)
    obs_ring: torch.Tensor  # (S, K, R, 5)
    obs_age: torch.Tensor  # (S, K, R)
    obs_ptr: torch.Tensor
    feat: torch.Tensor  # (S, K, D) smoothed feature
    has_feat: torch.Tensor  # (S, K) bool
    next_id: torch.Tensor  # (S,)
    frame_count: torch.Tensor  # (S,)


def _bbox_to_z5(xyxy, conf):
    """xyxy and score -> [u, v, s, c, r]."""
    w = xyxy[..., 2] - xyxy[..., 0]
    h = xyxy[..., 3] - xyxy[..., 1]
    u = xyxy[..., 0] + w * 0.5
    v = xyxy[..., 1] + h * 0.5
    s = w * h
    r = torch.where(h > 1e-6, w / torch.where(h > 1e-6, h, 1.0), 0.0)
    return torch.stack([u, v, s, conf, r], dim=-1)


def _x_to_bbox(x):
    """state -> xyxy."""
    u, v, s, r = x[..., 0], x[..., 1], x[..., 2], x[..., 4]
    w = torch.sqrt(s * r)
    h = s / torch.where(w != 0.0, w, 1e-12)
    return torch.stack([u - w / 2, v - h / 2, u + w / 2, v + h / 2], dim=-1)


def _kf_predict(x, P, Q):
    """F = I + U with U the velocity shift ((0..3) += (5..8)), so
    F P F' = P + U P + P U' + U P U' as slice adds, no 9x9 products."""
    new_x = x.clone()
    new_x[..., 0:4] += x[..., 5:9]
    new_P = P.clone()
    new_P[..., :4, :] += P[..., 5:9, :]  # U P
    new_P[..., :, :4] += P[..., :, 5:9]  # P U' (of the original P)
    new_P[..., :4, :4] += P[..., 5:9, 5:9]  # U P U'
    return new_x, new_P + Q


def _kf_update(x, P, z, R):
    """The plain (I - KH) P update (hybridsort.cpp:73-90); H = [I5 | 0],
    so (I - KH) P = P - K P[:5, :], a rank-5 correction."""
    S = P[..., :5, :5] + R
    PHt = P[..., :, :5]
    Kg = solve_spd(S, PHt.transpose(-1, -2)).transpose(-1, -2)
    prod = Kg * (z - x[..., :5])[..., None, :]
    corr = prod[..., 0]
    for i in range(1, 5):
        corr = corr + prod[..., i]
    return x + corr, P - matmul_small(Kg, P[..., :5, :])


def make_hybridsort(cfg: HybridSortConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> HybridState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N), embs (S, N, D) or
    None, warp (S, 2, 3) or None) -> (state, (out (S, K, 8),
    out_mask (S, K)))``."""
    K = cfg.max_tracks
    R = cfg.ring
    D = cfg.emb_dim
    dev = resolve_device(device)
    P09 = torch.diag(torch.tensor(_P09_DIAG, device=dev))
    # the step's constants on the device of its inputs
    consts = PerDevice.tensors(dev, torch.diag(torch.tensor(_Q9_DIAG,
                                                            device=dev)),
                               torch.diag(torch.tensor(_R5_DIAG, device=dev)),
                               P09)
    # giou, ciou and diou are plain IoU in the reference's private
    # dispatch (hybridsort.cpp:579-592)
    asso = hmiou_batch if cfg.asso_func == "hmiou" else iou_batch

    def init_fn(n_streams: int = 1) -> HybridState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        def full(shape, value, dtype=torch.float32):
            return torch.full((S,) + shape, value, dtype=dtype, device=dev)

        return HybridState(
            x=zeros(K, 9, dtype=torch.float32),
            P=P09.expand(S, K, 9, 9).clone(),
            active=zeros(K, dtype=torch.bool),
            tid=zeros(K),
            age=zeros(K),
            hits=zeros(K),
            hit_streak=zeros(K),
            tsu=zeros(K),
            conf=zeros(K, dtype=torch.float32),
            conf_pre=zeros(K, dtype=torch.float32),
            cls=zeros(K, dtype=torch.float32),
            det_ind=full((K,), -1, torch.int32),
            last_obs=full((K, 5), -1.0),
            obs_ring=full((K, R, 5), -1.0),
            obs_age=full((K, R), _NO_AGE, torch.int32),
            obs_ptr=zeros(K),
            feat=zeros(K, D, dtype=torch.float32),
            has_feat=zeros(K, dtype=torch.bool),
            next_id=zeros(),
            frame_count=zeros(),
        )

    def _apply_update(v: dict, t2d, dets, det_conf, dets_feat, det_has_feat,
                      frame_age, feat_mask):
        """The update of every matched track, all stages at once, on the
        fields of ``v`` (updated in place); ``feat_mask`` (S, K) marks the
        rows whose feature may update (stage-1 matches only,
        hybridsort.cpp:1010)."""
        N = dets.shape[1]
        m = t2d >= 0
        j = t2d.clamp(0, N - 1)
        jl = j.long()
        dbox = select.gather_rows(dets[..., :4], j)
        dconf = det_conf.gather(1, jl)

        new_obs = torch.cat([dbox, dconf[..., None]], dim=-1)
        slot = v["obs_ptr"] % R
        v["obs_ring"] = select.write_slot(v["obs_ring"], slot, new_obs, m)
        v["obs_age"] = select.write_slot_scalar(v["obs_age"], slot, frame_age,
                                                m)
        v["obs_ptr"] = torch.where(m, v["obs_ptr"] + 1, v["obs_ptr"])
        v["last_obs"] = torch.where(m[..., None], new_obs, v["last_obs"])

        v["tsu"] = torch.where(m, 0, v["tsu"])
        v["hits"] = torch.where(m, v["hits"] + 1, v["hits"])
        v["hit_streak"] = torch.where(m, v["hit_streak"] + 1, v["hit_streak"])
        v["cls"] = torch.where(m, dets[..., 5].gather(1, jl), v["cls"])
        v["det_ind"] = torch.where(m, j, v["det_ind"])

        R5 = consts.on(dets.device)[1]
        ux, uP = _kf_update(v["x"], v["P"], _bbox_to_z5(dbox, dconf), R5)
        v["x"] = torch.where(m[..., None], ux, v["x"])
        v["P"] = torch.where(m[..., None, None], uP, v["P"])

        conf, feat = v["conf"], v["feat"]
        if cfg.with_reid:
            dfeat = select.gather_rows(dets_feat, j)
            if cfg.adapfs:
                pre_w = cfg.alpha * (conf / (conf + dconf + 1e-12))
                cur_w = (1.0 - cfg.alpha) * (dconf / (conf + dconf + 1e-12))
                tot = pre_w + cur_w
                pre_w = pre_w / torch.where(tot > 0, tot, 1.0)
                cur_w = cur_w / torch.where(tot > 0, tot, 1.0)
                smoothed = pre_w[..., None] * feat + cur_w[..., None] * dfeat
            else:
                smoothed = cfg.alpha * feat + (1.0 - cfg.alpha) * dfeat
            nrm = torch.linalg.vector_norm(smoothed, dim=-1,
                                           keepdim=True) + 1e-12
            smoothed = smoothed / nrm
            new_feat = torch.where(v["has_feat"][..., None], smoothed, dfeat)
            upd = feat_mask & m & det_has_feat.gather(1, jl)
            v["feat"] = torch.where(upd[..., None], new_feat, feat)
            v["has_feat"] = v["has_feat"] | upd

        v["conf_pre"] = torch.where(m, conf, v["conf_pre"])
        v["conf"] = torch.where(m, dconf, conf)

    def step_fn(state: HybridState, dets, det_mask, embs=None, warp=None):
        S, N = det_mask.shape
        Q9, R5, P09 = consts.on(dets.device)
        frame = state.frame_count + 1
        det_conf = dets[..., 4]
        det_xyxy = dets[..., :4]
        any_det = det_mask.any(-1)  # (S,); no det: an empty raw input

        keep = det_mask & (det_conf > cfg.det_thresh)
        second = det_mask & (det_conf > cfg.low_thresh) & (
            det_conf < cfg.det_thresh)

        if cfg.with_reid and embs is not None:
            dets_feat = embs[..., :D]
            n = torch.linalg.vector_norm(dets_feat, dim=-1, keepdim=True)
            det_has_feat = det_mask & (n[..., 0] > 0)
            dets_feat = dets_feat / torch.where(n > 0, n, 1.0)
        else:
            dets_feat = torch.ones((S, N, D), device=dets.device)
            det_has_feat = torch.zeros_like(det_mask)

        act = state.active
        x = state.x
        # --- camera motion before the predict (hybridsort.cpp:91-121):
        #     [u, v, s, c, r] from the warped corners, velocities zeroed --
        if warp is not None:
            p1, p2 = warp_corners(_x_to_bbox(x), warp)
            wn = p2[..., 0] - p1[..., 0]
            hn = p2[..., 1] - p1[..., 1]
            un = p1[..., 0] + wn / 2.0
            vn = p1[..., 1] + hn / 2.0
            sn = wn * hn
            rn = torch.where(hn > 1e-6, wn / torch.where(hn > 1e-6, hn, 1.0),
                             0.0)
            warped = torch.stack([un, vn, sn, x[..., 3], rn], dim=-1)
            new_x9 = torch.cat([warped, torch.zeros_like(x[..., :4])], dim=-1)
            x = torch.where((act & any_det[:, None])[..., None], new_x9, x)

        # --- predict, scale velocity clamped (hybridsort.cpp:258-272) ------
        clamp = (x[..., 7] + x[..., 2]) <= 0
        x = torch.cat([x[..., :7],
                       torch.where(clamp, 0.0, x[..., 7])[..., None],
                       x[..., 8:]], dim=-1)
        px, pP = _kf_predict(x, state.P, Q9)
        x = torch.where(act[..., None], px, state.x)
        P = torch.where(act[..., None, None], pP, state.P)
        age = torch.where(act, state.age + 1, state.age)
        hit_streak = torch.where(act & (state.tsu > 0), 0, state.hit_streak)
        tsu = torch.where(act, state.tsu + 1, state.tsu)
        active = act

        # track rows (hybridsort.cpp:936-952)
        kf_box = _x_to_bbox(x)
        obs_valid = state.last_obs[..., :4].sum(-1) >= 0
        trk_box = torch.where(obs_valid[..., None], state.last_obs[..., :4],
                              kf_box)
        simple_score = torch.where(
            state.conf_pre == 0.0,
            state.conf.clamp(0.1, cfg.track_thresh),
            (state.conf - (state.conf_pre - state.conf)).clamp(
                0.1, cfg.track_thresh))

        # ================= stage 1 =========================================
        iou1 = asso(det_xyxy, trk_box)  # (S, N, K)
        gate1 = (cfg.tcm_first_step & keep.any(-1) & active.any(-1))[:, None]
        use_reid1 = cfg.with_reid and cfg.eg_weight_high_score > 0
        if use_reid1 or (cfg.with_reid and cfg.eg_weight_low_score > 0):
            # float32 products (TF32 stays off); the BYTE stage reads the
            # pre-update features, identical on every column it solves
            emb_dist = 1.0 - torch.matmul(dets_feat,
                                          state.feat.transpose(-1, -2))
            emb_dist = torch.where(
                det_has_feat[..., :, None] & state.has_feat[..., None, :],
                emb_dist, 1.0)
        if use_reid1:
            cost1 = (1.0 - iou1) + emb_dist * cfg.eg_weight_high_score
            thresh1 = (1.0 - cfg.iou_threshold) + cfg.eg_weight_high_score
        else:
            cost1 = 1.0 - iou1
            thresh1 = 1.0 - cfg.iou_threshold
        d2t1, _ = solve_lap_masked(cost1, keep & gate1, active & gate1,
                                   thresh1, impl=cfg.lap_impl)
        sel_iou = select.take_per_row(iou1, d2t1)
        ok = sel_iou >= cfg.iou_threshold
        if use_reid1 and cfg.with_longterm_reid_correction:
            # the long-term correction rescue
            sel_emb = select.take_per_row(emb_dist, d2t1)
            ok = ok | ((sel_iou >= cfg.iou_threshold / 2.0) & (sel_emb <= 0.3))
        d2t1 = torch.where((d2t1 >= 0) & ok, d2t1, -1)
        t2d1 = select.invert_matching(d2t1, K)

        # The later stages read state only on rows stage 1 left
        # unmatched, so all stages' updates merge into one at the end;
        # only stage-1 matches update features.
        t2d_all = t2d1
        u_trk = active & (t2d1 < 0)
        u_det = keep & (d2t1 < 0)

        # ================= BYTE stage ======================================
        if cfg.use_byte:
            iou_b = iou_batch(det_xyxy, trk_box)
            if cfg.tcm_byte_step:
                score_diff = (simple_score[..., None, :]
                              - det_conf[..., :, None]).abs()
                iou_b = iou_b - score_diff * cfg.tcm_byte_step_weight
            cost_b = 1.0 - iou_b
            if cfg.with_reid and cfg.eg_weight_low_score > 0:
                cost_b = cost_b + emb_dist * cfg.eg_weight_low_score
            _, t2d_b = _gated_rematch(iou_b, cost_b, second, u_trk,
                                      cfg.iou_threshold,
                                      1.0 - cfg.iou_threshold, cfg.lap_impl)
            t2d_all = torch.where(t2d_all >= 0, t2d_all, t2d_b)
            u_trk = u_trk & (t2d_b < 0)

        # ================= final rematch on the last boxes =================
        # pre-update last_obs, identical on the u_trk columns
        iou_r = iou_batch(det_xyxy, state.last_obs[..., :4])
        d2t_r, t2d_r = _gated_rematch(iou_r, 1.0 - iou_r, u_det, u_trk,
                                      cfg.iou_threshold,
                                      1.0 - cfg.iou_threshold, cfg.lap_impl)
        t2d_all = torch.where(t2d_all >= 0, t2d_all, t2d_r)
        v = dict(x=x, P=P, conf=state.conf, conf_pre=state.conf_pre,
                 cls=state.cls, det_ind=state.det_ind,
                 last_obs=state.last_obs, obs_ring=state.obs_ring,
                 obs_age=state.obs_age, obs_ptr=state.obs_ptr, tsu=tsu,
                 hits=state.hits, hit_streak=hit_streak, feat=state.feat,
                 has_feat=state.has_feat)
        _apply_update(v, t2d_all, dets, det_conf, dets_feat, det_has_feat,
                      age, t2d1 >= 0)
        u_trk = u_trk & (t2d_r < 0)
        u_det = u_det & (d2t_r < 0)

        # --- null update toward a zero measurement (hybridsort.cpp:322-328),
        #     not on an empty raw input ------------------------------------
        null_m = u_trk & any_det[:, None]
        zx, zP = _kf_update(v["x"], v["P"], torch.zeros_like(v["x"][..., :5]),
                            R5)
        x = torch.where(null_m[..., None], zx, v["x"])
        P = torch.where(null_m[..., None, None], zP, v["P"])
        conf_pre = torch.where(null_m, 0.0, v["conf_pre"])

        # --- births ------------------------------------------------------
        free = ~active
        births, bdet, slot_rank = select.birth_slots(
            free, u_det & any_det[:, None])
        bl = bdet.long()
        bconf = det_conf.gather(1, bl)
        bz = _bbox_to_z5(select.gather_rows(det_xyxy, bdet), bconf)
        b1, b2, b3 = births[..., None], births[..., None, None], births
        x = torch.where(b1, torch.cat([bz, torch.zeros_like(bz[..., :4])], -1),
                        x)
        P = torch.where(b2, P09, P)
        conf = torch.where(b3, bconf, v["conf"])
        conf_pre = torch.where(b3, 0.0, conf_pre)
        cls = torch.where(b3, dets[..., 5].gather(1, bl), v["cls"])
        det_ind = torch.where(b3, bdet, v["det_ind"])
        age = torch.where(b3, 0, age)
        hits = torch.where(b3, 0, v["hits"])
        hit_streak = torch.where(b3, 0, v["hit_streak"])
        tsu = torch.where(b3, 0, v["tsu"])
        last_obs = torch.where(b1, -1.0, v["last_obs"])
        obs_ring = torch.where(b2, -1.0, v["obs_ring"])
        obs_age = torch.where(b1, _NO_AGE, v["obs_age"])
        obs_ptr = torch.where(b3, 0, v["obs_ptr"])
        feat = torch.where(b1, select.gather_rows(dets_feat, bdet), v["feat"])
        has_feat = torch.where(b3, det_has_feat.gather(1, bl), v["has_feat"])
        tid = torch.where(b3, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        n_new = (u_det & any_det[:, None]).sum(1, dtype=torch.int32)
        next_id = state.next_id + torch.minimum(
            n_new, free.sum(1, dtype=torch.int32))
        active = active | births

        # --- output, ids + 1 (hybridsort.cpp:1226-1238) --------------------
        obs_ok = last_obs[..., :4].sum(-1) >= 0
        out_box = torch.where(obs_ok[..., None], last_obs[..., :4],
                              _x_to_bbox(x))
        out_mask = (active & (tsu < 1)
                    & ((hit_streak >= cfg.min_hits)
                       | (frame <= cfg.min_hits)[:, None]))
        out = torch.cat(
            [out_box, (tid + 1)[..., None].to(torch.float32), conf[..., None],
             cls[..., None], det_ind[..., None].to(torch.float32)],
            dim=-1,
        )

        active = active & (tsu <= cfg.max_age)

        new_state = HybridState(
            x=x, P=P, active=active, tid=tid, age=age, hits=hits,
            hit_streak=hit_streak, tsu=tsu, conf=conf, conf_pre=conf_pre,
            cls=cls, det_ind=det_ind, last_obs=last_obs, obs_ring=obs_ring,
            obs_age=obs_age, obs_ptr=obs_ptr, feat=feat, has_feat=has_feat,
            next_id=next_id, frame_count=frame,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("hybridsort")
class HybridSort(BaseTrackerWrapper):
    """Host-facing HybridSORT (reference: hybridsort.hpp:127-164). The
    host ECC warps every frame that has a detection."""

    def __init__(
        self,
        reid_weights: str = "",
        use_half: bool = False,
        use_gpu: bool = False,
        det_thresh: float = 0.7,
        max_age: int = 30,
        max_obs: int = 50,
        min_hits: int = 3,
        iou_threshold: float = 0.15,
        per_class: bool = False,
        nr_classes: int = 80,
        asso_func: str = "hmiou",
        is_obb: bool = False,
        low_thresh: float = 0.1,
        delta_t: int = 3,
        inertia: float = 0.05,
        use_byte: bool = True,
        use_custom_kf: bool = True,
        longterm_bank_length: int = 30,
        alpha: float = 0.9,
        adapfs: bool = False,
        track_thresh: float = 0.5,
        EG_weight_high_score: float = 4.6,
        EG_weight_low_score: float = 1.3,
        TCM_first_step: bool = True,
        TCM_byte_step: bool = True,
        TCM_byte_step_weight: float = 1.0,
        high_score_matching_thresh: float = 0.7,
        with_longterm_reid: bool = True,
        longterm_reid_weight: float = 0.0,
        with_longterm_reid_correction: bool = True,
        longterm_reid_correction_thresh: float = 0.4,
        longterm_reid_correction_thresh_low: float = 0.4,
        cmc_method: str = "ecc",
        with_reid: bool = True,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        emb_dim: int = 1,
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, emb_dim=emb_dim, device=device)
        # accepted for the reference's constructor signature; unused
        del per_class, nr_classes, is_obb, use_half, use_gpu, use_custom_kf
        del cmc_method
        self.reid_weights = reid_weights
        self._cfg_kw = dict(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            asso_func=asso_func,
            low_thresh=low_thresh,
            delta_t=delta_t,
            inertia=inertia,
            use_byte=use_byte,
            longterm_bank_length=longterm_bank_length,
            alpha=alpha,
            adapfs=adapfs,
            track_thresh=track_thresh,
            eg_weight_high_score=EG_weight_high_score,
            eg_weight_low_score=EG_weight_low_score,
            tcm_first_step=TCM_first_step,
            tcm_byte_step=TCM_byte_step,
            tcm_byte_step_weight=TCM_byte_step_weight,
            high_score_matching_thresh=high_score_matching_thresh,
            with_longterm_reid=with_longterm_reid,
            longterm_reid_weight=longterm_reid_weight,
            with_longterm_reid_correction=with_longterm_reid_correction,
            longterm_reid_correction_thresh=longterm_reid_correction_thresh,
            longterm_reid_correction_thresh_low=(
                longterm_reid_correction_thresh_low),
            with_reid=with_reid,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self._cmc = None
        self._build(emb_dim)

    def _build(self, emb_dim: int):
        self.cfg = HybridSortConfig(**self._cfg_kw, emb_dim=emb_dim)
        self._init, self._core_step = make_hybridsort(self.cfg,
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
        # ECC on frames with detections (hybridsort.cpp:846-857)
        if img is None or dets.shape[0] == 0:
            return None
        if self._cmc is None:
            from motcpp_tpu_torch.motion.cmc import ECC

            self._cmc = ECC()
        return self._cmc.apply(img, dets)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask, embs, warp=warp)
