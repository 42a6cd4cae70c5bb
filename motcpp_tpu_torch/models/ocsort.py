"""OC-SORT: observation-centric SORT, batched over streams.

Counterpart of ``motcpp_tpu/models/ocsort.py``; its module doc lists the
reference behaviours this step replicates (reference:
src/trackers/ocsort.cpp:53-738). Every tensor of the state has a
leading stream dimension S, and one call of the step advances all S
streams by one frame. Each track keeps a ring of its last ``delta_t + 2``
observations keyed by the age at which each was recorded, so
``k_previous_obs`` is one gather. Per frame: the XYSR predict (scale
velocity clamped), stage 1 on -(IoU + the velocity-direction term) with
the trivial one-to-one shortcut, the optional BYTE stage on the
low-confidence dets, the OCR rematch against the tracks' last
observations, one merged observation update, births and the output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.models import register
from motcpp_tpu_torch.models.base import BaseTrackerWrapper
from motcpp_tpu_torch.ops import boxes, select
from motcpp_tpu_torch.ops.iou import get_asso_fn
from motcpp_tpu_torch.ops.kalman.xysr import (
    DIM_X,
    XYSRParams,
    xysr_init,
    xysr_predict,
    xysr_update,
)
from motcpp_tpu_torch.ops.lap import solve_lap_masked


@dataclasses.dataclass(frozen=True)
class OCSortConfig:
    """Reference defaults: ocsort.hpp:88-102."""

    det_thresh: float = 0.2
    max_age: int = 30
    max_obs: int = 50
    min_hits: int = 3
    iou_threshold: float = 0.3
    asso_func: str = "iou"
    min_conf: float = 0.1
    delta_t: int = 3
    inertia: float = 0.2
    use_byte: bool = False
    q_xy_scaling: float = 0.01
    q_s_scaling: float = 0.0001
    max_tracks: int = 256
    max_dets: int = 128
    lap_impl: str = "jv"
    frame_width: int = 1920
    frame_height: int = 1080

    @property
    def ring(self) -> int:
        return self.delta_t + 2


class OCSortState(NamedTuple):
    x: torch.Tensor  # (S, K, 7)
    P: torch.Tensor  # (S, K, 7, 7)
    active: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32 (the output emits tid + 1)
    age: torch.Tensor  # (S, K) int32, predicts since birth
    hits: torch.Tensor  # (S, K) int32
    hit_streak: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32, time since update
    conf: torch.Tensor  # (S, K) float32
    cls: torch.Tensor  # (S, K) float32
    det_ind: torch.Tensor  # (S, K) int32
    last_obs: torch.Tensor  # (S, K, 5) [x1, y1, x2, y2, conf]; -1 sentinel
    velocity: torch.Tensor  # (S, K, 2) (dy, dx)
    obs_ring: torch.Tensor  # (S, K, R, 5)
    obs_age: torch.Tensor  # (S, K, R) int32, _NO_AGE sentinel
    obs_ptr: torch.Tensor  # (S, K) int32 ring write pointer
    next_id: torch.Tensor  # (S,) int32
    frame_count: torch.Tensor  # (S,) int32


_NO_AGE = -(10 ** 6)
_WIN_PRIORITY = 2 ** 30


def _speed_direction(box_from, box_to):
    """Normalised (dy, dx) between box centres (ocsort.cpp:160-171)."""
    cx1 = (box_from[..., 0] + box_from[..., 2]) * 0.5
    cy1 = (box_from[..., 1] + box_from[..., 3]) * 0.5
    cx2 = (box_to[..., 0] + box_to[..., 2]) * 0.5
    cy2 = (box_to[..., 1] + box_to[..., 3]) * 0.5
    dy = cy2 - cy1
    dx = cx2 - cx1
    norm = torch.sqrt(dy * dy + dx * dx) + 1e-6
    return torch.stack([dy / norm, dx / norm], dim=-1)


def _k_previous_obs(obs_ring, obs_age, age, delta_t):
    """k_previous_obs (ocsort.cpp:24-51): the observation of the oldest
    age in age - delta_t .. age - 1, else the newest one, else the -1
    placeholder. Ring ages are unique per track, so this is one argmax
    of a priority score: a window hit outranks every age."""
    has_any = (obs_age > _NO_AGE).any(-1)
    dt = age[..., None] - obs_age
    in_window = (dt >= 1) & (dt <= delta_t)
    score = torch.where(in_window, _WIN_PRIORITY + dt, obs_age)
    result = select.take_slot(obs_ring, score.argmax(-1))
    return torch.where(has_any[..., None], result, -1.0)


def _gated_greedy_or_lap(iou_mat, row_mask, col_mask, thresh):
    """Stage 1's trivial matching (ocsort.cpp:684-696): per problem,
    whether every row and column has at most one candidate above
    ``thresh``, and each row's candidate (-1 if none)."""
    pair = row_mask[..., :, None] & col_mask[..., None, :]
    cand = torch.where(pair, iou_mat, 0.0) > thresh
    row_sums = cand.sum(-1)
    col_sums = cand.sum(-2)
    trivial = (row_sums.amax(-1) <= 1) & (col_sums.amax(-1) <= 1)
    d2t = torch.where(row_sums == 1,
                      cand.to(torch.uint8).argmax(-1).to(torch.int32), -1)
    return trivial, d2t


def _filter_by_iou(d2t, iou_mat, thresh):
    """Keep the matches whose raw IoU clears ``thresh``."""
    return torch.where((d2t >= 0) & (select.take_per_row(iou_mat, d2t)
                                     >= thresh), d2t, -1)


def _angle_cost(det_xyxy, det_conf, k_obs, velocity, inertia):
    """Stage 1's velocity-direction term: for each det and track, how
    well the direction from the track's k-back observation to the det
    agrees with the track's velocity, weighted by ``inertia`` and the
    det's confidence; 0 without a k-back observation. (S, N) dets,
    (S, K) tracks -> (S, N, K)."""
    dcx = ((det_xyxy[..., 0] + det_xyxy[..., 2]) * 0.5)[..., :, None]
    dcy = ((det_xyxy[..., 1] + det_xyxy[..., 3]) * 0.5)[..., :, None]
    pcx = ((k_obs[..., 0] + k_obs[..., 2]) * 0.5)[..., None, :]
    pcy = ((k_obs[..., 1] + k_obs[..., 3]) * 0.5)[..., None, :]
    dx = dcx - pcx
    dy = dcy - pcy
    norm = torch.sqrt(dx * dx + dy * dy) + 1e-6
    cos = (velocity[..., None, :, 1] * (dx / norm)
           + velocity[..., None, :, 0] * (dy / norm)).clamp(-1.0, 1.0)
    diff_angle = (math.pi / 2.0 - torch.acos(cos).abs()) / math.pi
    valid_prev = (k_obs[..., 4] >= 0)[..., None, :]
    return (torch.where(valid_prev, diff_angle, 0.0) * inertia
            * det_conf[..., :, None])


def _observe(v: dict, t2d, dets, frame_age, delta_t, kf):
    """The observation update of every track matched to a det
    (ocsort.cpp:87-130), all stages at once, on the fields of ``v`` (a
    dict of the state's tensors, updated in place)."""
    N = dets.shape[1]
    R = v["obs_ring"].shape[-2]
    m = t2d >= 0
    j = t2d.clamp(0, N - 1)
    drow = select.gather_rows(dets, j)
    dbox = drow[..., :4]

    # velocity from the k-back (or last) observation to the new box
    last_obs = v["last_obs"]
    has_prev = last_obs[..., :4].sum(-1) >= 0
    k_prev = _k_previous_obs(v["obs_ring"], v["obs_age"], frame_age, delta_t)
    k_valid = k_prev[..., :4].sum(-1) >= 0
    ref_box = torch.where(k_valid[..., None], k_prev[..., :4],
                          last_obs[..., :4])
    v["velocity"] = torch.where((m & has_prev)[..., None],
                                _speed_direction(ref_box, dbox),
                                v["velocity"])

    # the observation goes into the ring
    new_obs = torch.cat([dbox, drow[..., 4:5]], dim=-1)
    slot = v["obs_ptr"] % R
    v["obs_ring"] = select.write_slot(v["obs_ring"], slot, new_obs, m)
    v["obs_age"] = select.write_slot_scalar(v["obs_age"], slot, frame_age, m)
    v["obs_ptr"] = torch.where(m, v["obs_ptr"] + 1, v["obs_ptr"])
    v["last_obs"] = torch.where(m[..., None], new_obs, last_obs)

    v["tsu"] = torch.where(m, 0, v["tsu"])
    v["hits"] = torch.where(m, v["hits"] + 1, v["hits"])
    v["hit_streak"] = torch.where(m, v["hit_streak"] + 1, v["hit_streak"])
    v["conf"] = torch.where(m, drow[..., 4], v["conf"])
    v["cls"] = torch.where(m, drow[..., 5], v["cls"])
    v["det_ind"] = torch.where(m, j, v["det_ind"])

    ux, uP = xysr_update(v["x"], v["P"], boxes.xyxy2xysr(dbox), kf)
    v["x"] = torch.where(m[..., None], ux, v["x"])
    v["P"] = torch.where(m[..., None, None], uP, v["P"])


def _gated_rematch(iou_mat, cost, rows, cols, iou_thresh, cost_thresh,
                   lap_impl):
    """A gated stage (OC-SORT's BYTE and OCR, ocsort.cpp:429-540, and
    its kin in DeepOC-SORT and HybridSORT): ``cost`` is solved only in
    the streams where some candidate pair's ``iou_mat`` clears
    ``iou_thresh``, and a match stands only where its ``iou_mat`` does.
    Returns det -> track (S, N) and track -> det (S, K)."""
    masked = torch.where(rows[..., :, None] & cols[..., None, :], iou_mat,
                         -torch.inf)
    gate = (rows.any(-1) & cols.any(-1)
            & (masked.amax((-2, -1)) > iou_thresh))[:, None]
    d2t, _ = solve_lap_masked(cost, rows & gate, cols & gate, cost_thresh,
                              impl=lap_impl)
    d2t = _filter_by_iou(d2t, iou_mat, iou_thresh)
    return d2t, select.invert_matching(d2t, iou_mat.shape[-1])


def make_ocsort(cfg: OCSortConfig, device="cuda"):
    """Returns ``init_fn(n_streams=1) -> OCSortState`` and
    ``step_fn(state, dets (S, N, 6), det_mask (S, N)) ->
    (state, (out (S, K, 8), out_mask (S, K)))``."""
    K = cfg.max_tracks
    R = cfg.ring
    dev = resolve_device(device)
    kf = XYSRParams(q_xy_scaling=cfg.q_xy_scaling,
                    q_s_scaling=cfg.q_s_scaling)
    asso = get_asso_fn(cfg.asso_func, cfg.frame_width, cfg.frame_height)

    def init_fn(n_streams: int = 1) -> OCSortState:
        S = int(n_streams)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        def full(shape, value, dtype=torch.float32):
            return torch.full((S,) + shape, value, dtype=dtype, device=dev)

        return OCSortState(
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
            next_id=zeros(),
            frame_count=zeros(),
        )

    def step_fn(state: OCSortState, dets, det_mask, embs=None):
        del embs
        frame = state.frame_count + 1
        det_conf = dets[..., 4]
        det_xyxy = dets[..., :4]

        high = det_mask & (det_conf > cfg.det_thresh)
        second = det_mask & (det_conf > cfg.min_conf) & (
            det_conf < cfg.det_thresh)

        # --- predict, scale velocity clamped (ocsort.cpp:132-144) --------
        act = state.active
        clamp = (state.x[..., 6] + state.x[..., 2]) <= 0
        x_in = torch.cat([state.x[..., :6],
                          torch.where(clamp, 0.0, state.x[..., 6])[..., None]],
                         dim=-1)
        px, pP = xysr_predict(x_in, state.P, kf)
        x = torch.where(act[..., None], px, state.x)
        P = torch.where(act[..., None, None], pP, state.P)
        age = torch.where(act, state.age + 1, state.age)
        hit_streak = torch.where(act & (state.tsu > 0), 0, state.hit_streak)
        tsu = torch.where(act, state.tsu + 1, state.tsu)

        trk_xyxy = boxes.xysr2xyxy(x[..., :4])
        active = act & torch.isfinite(trk_xyxy).all(-1)
        had_tracks = active.any(-1)

        # --- stage 1: velocity-direction consistency ---------------------
        k_obs = _k_previous_obs(state.obs_ring, state.obs_age, age,
                                cfg.delta_t)
        iou_mat = asso(det_xyxy, trk_xyxy)  # (S, N, K) dets x tracks
        angle_cost = _angle_cost(det_xyxy, det_conf, k_obs, state.velocity,
                                 cfg.inertia)

        trivial, d2t_trivial = _gated_greedy_or_lap(iou_mat, high, active,
                                                    cfg.iou_threshold)
        d2t_lap, _ = solve_lap_masked(-(iou_mat + angle_cost), high, active,
                                      -cfg.iou_threshold, impl=cfg.lap_impl)
        d2t_lap = _filter_by_iou(d2t_lap, iou_mat, cfg.iou_threshold)
        d2t = torch.where(trivial[:, None], d2t_trivial, d2t_lap)
        t2d = select.invert_matching(d2t, K)

        # The later stages read only rows stage 1 left unmatched, so all
        # stages' observation updates merge into one at the end.
        t2d_all = t2d
        u_trk = active & (t2d < 0)
        u_det = high & (d2t < 0)

        # --- BYTE stage on the predicted boxes (ocsort.cpp:429-472) ------
        if cfg.use_byte:
            _, t2d_2 = _gated_rematch(iou_mat, -iou_mat, second, u_trk,
                                      cfg.iou_threshold, -cfg.iou_threshold,
                                      cfg.lap_impl)
            t2d_all = torch.where(t2d_all >= 0, t2d_all, t2d_2)
            u_trk = u_trk & (t2d_2 < 0)

        # --- OCR rematch on the last observations (ocsort.cpp:474-540);
        #     last_obs is unchanged on every unmatched column -------------
        iou3 = asso(det_xyxy, state.last_obs[..., :4])
        d2t_3, t2d_3 = _gated_rematch(iou3, -iou3, u_det, u_trk,
                                      cfg.iou_threshold, -cfg.iou_threshold,
                                      cfg.lap_impl)
        t2d_all = torch.where(t2d_all >= 0, t2d_all, t2d_3)
        v = dict(x=x, P=P, conf=state.conf, cls=state.cls,
                 det_ind=state.det_ind, last_obs=state.last_obs,
                 velocity=state.velocity, obs_ring=state.obs_ring,
                 obs_age=state.obs_age, obs_ptr=state.obs_ptr, tsu=tsu,
                 hits=state.hits, hit_streak=hit_streak)
        _observe(v, t2d_all, dets, age, cfg.delta_t, kf)
        u_trk = u_trk & (t2d_3 < 0)
        u_det = u_det & (d2t_3 < 0)

        # --- null update: det_ind = 0 (ocsort.cpp:543-545, 87-88) --------
        det_ind = torch.where(u_trk, 0, v["det_ind"])

        # --- births ------------------------------------------------------
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
        # internal ids start at 1 (ocsort.hpp:32-35 returns ++count)
        tid = torch.where(b3, state.next_id[:, None] + 1 + slot_rank,
                          state.tid)
        next_id = state.next_id + torch.minimum(
            u_det.sum(1, dtype=torch.int32), free.sum(1, dtype=torch.int32))
        active = active | births

        # --- output, none when no track existed (ocsort.cpp:366-383);
        #     births count from the output loop (ocsort.cpp:548-562) -----
        obs_valid = last_obs[..., :4].sum(-1) >= 0
        out_box = torch.where(obs_valid[..., None], last_obs[..., :4],
                              boxes.xysr2xyxy(x[..., :4]))
        out_mask = (had_tracks[:, None] & active & (tsu < 1)
                    & ((hit_streak >= cfg.min_hits)
                       | (frame <= cfg.min_hits)[:, None]))
        out = torch.cat(
            [out_box, (tid + 1)[..., None].to(torch.float32), conf[..., None],
             cls[..., None], det_ind[..., None].to(torch.float32)],
            dim=-1,
        )

        # --- deaths ------------------------------------------------------
        active = active & (tsu <= cfg.max_age)

        new_state = OCSortState(
            x=x, P=P, active=active, tid=tid, age=age, hits=hits,
            hit_streak=hit_streak, tsu=tsu, conf=conf, cls=cls,
            det_ind=det_ind, last_obs=last_obs, velocity=velocity,
            obs_ring=obs_ring, obs_age=obs_age, obs_ptr=obs_ptr,
            next_id=next_id, frame_count=frame,
        )
        return new_state, (out, out_mask)

    return init_fn, step_fn


@register("ocsort")
class OCSort(BaseTrackerWrapper):
    """Host-facing OC-SORT (reference: ocsort.hpp:88-102 defaults; eval
    construction motcpp_eval.cpp:149-166)."""

    def __init__(
        self,
        det_thresh: float = 0.2,
        max_age: int = 30,
        max_obs: int = 50,
        min_hits: int = 3,
        iou_threshold: float = 0.3,
        per_class: bool = False,
        nr_classes: int = 80,
        asso_func: str = "iou",
        is_obb: bool = False,
        min_conf: float = 0.1,
        delta_t: int = 3,
        inertia: float = 0.2,
        use_byte: bool = False,
        Q_xy_scaling: float = 0.01,
        Q_s_scaling: float = 0.0001,
        max_tracks: int = 256,
        max_dets: int = 128,
        lap_impl: str = "jv",
        device="cuda",
    ):
        super().__init__(max_dets=max_dets, device=device)
        # accepted for the reference's constructor signature; unused
        del per_class, nr_classes, is_obb
        self._cfg_kw = dict(
            det_thresh=det_thresh,
            max_age=max_age,
            max_obs=max_obs,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            asso_func=asso_func,
            min_conf=min_conf,
            delta_t=delta_t,
            inertia=inertia,
            use_byte=use_byte,
            q_xy_scaling=Q_xy_scaling,
            q_s_scaling=Q_s_scaling,
            max_tracks=max_tracks,
            max_dets=max_dets,
            lap_impl=lap_impl,
        )
        self._build()

    def _build(self, **frame_size):
        self.cfg = OCSortConfig(**self._cfg_kw, **frame_size)
        self._init, self._core_step = make_ocsort(self.cfg, device=self.device)

    def _setup_first_frame(self, dets, img):
        # the centroid similarities need the true frame size
        refresh = not self._first_frame_processed and img is not None
        super()._setup_first_frame(dets, img)
        if refresh and self.cfg.asso_func.startswith("centroid"):
            self._build(frame_width=self.frame_width,
                        frame_height=self.frame_height)

    def _init_state(self):
        return self._init(1)

    def _step(self, state, dets, det_mask, embs, warp):
        return self._core_step(state, dets, det_mask)
