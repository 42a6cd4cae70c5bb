"""Multi-stream tracking: all streams per step, a loop over frames, the
stream axis sharded over devices.

Counterpart of ``motcpp_tpu/parallel/streams.py`` (``make_rollout``,
``make_rollout_embs``, ``make_rollout_general``, ``embedding_priority``
and ``MultiStreamRunner``). The step already takes every stream at once
(a leading S dimension), so a rollout is a Python loop over the T
frames, where the JAX package scans. With an ``embed_fn`` the embedding
leg is live ReID: the rollout takes raw uint8 crops and runs the CNN
over each frame's crops before the tracker step. With a ``cmc_fn`` the
warp leg is live camera motion: the rollout takes grayscale frames and
estimates each frame's warps on the device. Given ``devices``, the
runner splits the streams into one shard per device, each run by a
one-device runner on its device, where the JAX package runs its rollout
under ``shard_map``; the shards never communicate.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.iou import iou_batch
from motcpp_tpu_torch.parallel.collectives import (
    Mesh,
    resolve_mesh,
    shard_over_streams,
)


def make_rollout(step_fn: Callable):
    """Build ``rollout(states, dets, masks) -> (states, (outs, out_masks))``
    for a stream-batched step: dets (T, S, N, D) and masks (T, S, N) give
    outs (T, S, K, 8) and out_masks (T, S, K)."""
    return make_rollout_general(step_fn)


def make_rollout_embs(step_fn: Callable):
    """Like make_rollout for ReID trackers: the step also takes each
    frame's embeddings, given as (T, S, N, D)."""
    return make_rollout_general(step_fn, with_embs=True)


def _wrap_int32(v):
    """int64 values reduced to int32 two's complement, as int32
    arithmetic wraps."""
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


def embedding_priority(d, m, pd, pm, t, rot: int = 8):
    """Embedding priority per detection slot (S, N): which crops deserve
    the CNN budget this frame (JAX ``parallel/streams.py:68-113``).

        2 * novelty + crowding + rotation + tie

    novelty is 1 - the max IoU against the previous frame's valid dets
    of the stream (1 when there are none), crowding the max IoU against
    the frame's other valid dets, rotation 1 where the box's grid cell
    hashes onto this frame's refresh slot ((cell + t) % rot == 0), and
    tie a small frame-varying jitter. The cell is built from the box's
    corner and the tie term is computed in int32 with wraparound, then
    floor-modded as the JAX package does: it decides which equal
    priorities fill the budget.

    d (S, N, >= 5) dets, m (S, N) valid, pd / pm the previous frame's,
    t the frame index (an int).
    """
    iou_prev = torch.where(pm[:, None, :], iou_batch(d[..., :4], pd[..., :4]),
                           0.0)
    novelty = 1.0 - iou_prev.amax(-1)
    novelty = torch.where(pm.any(-1)[:, None], novelty, 1.0)
    N = d.shape[1]
    eye = torch.eye(N, dtype=torch.bool, device=d.device)
    iou_self = torch.where(m[:, None, :] & ~eye,
                           iou_batch(d[..., :4], d[..., :4]), 0.0)
    crowd = iou_self.amax(-1)
    cell = (torch.round(d[..., 0] / 40.0)
            + torch.round(d[..., 1] / 40.0)).to(torch.int64)
    rotation = (torch.remainder(_wrap_int32(cell + t), rot) == 0).to(
        torch.float32)
    tie = torch.remainder(_wrap_int32(cell * 92837111 + t * 40499), 1021)
    tie = tie.to(torch.float32) * (0.01 / 1021.0)
    return 2.0 * novelty + crowd + rotation + tie


def make_rollout_general(step_fn: Callable, with_embs: bool = False,
                         with_warps: bool = False,
                         embed_fn: Callable | None = None,
                         crop_budget: int | None = None,
                         emb_cadence: int | None = None,
                         emb_priority: bool = False,
                         priority_rot: int = 8,
                         cmc_fn: Callable | None = None,
                         cmc_scale: float = 1.0):
    """Rollout with optional embedding (T, S, N, D), camera-warp
    (T, S, 2, 3), raw-crop and frame legs:

        rollout(states, dets, masks[, embs or crops][, warps])

    With ``embed_fn`` (appearance/reid.py::make_embed_fn) the embedding
    leg takes raw uint8 crops (T, S, N, Hc, Wc, 3) and each frame runs
    the CNN over its crops (appearance/reid.py::embed_valid_crops) before
    the tracker step. ``crop_budget`` caps the CNN batch per frame at the
    highest-confidence valid crops, or with ``emb_priority`` at the
    crops of highest :func:`embedding_priority` (``priority_rot`` is its
    rotation period).

    ``emb_cadence=k`` > 1: stream s embeds only on frames where
    ``(frame + s) % k == 0``; between refreshes a detection carries a
    zero embedding (no appearance for that frame) and the batch shrinks
    to ceil(S/k)*N crops unless crop_budget caps it lower. The rollout
    then takes ``frame0`` (the global frame index of its first frame)
    and ``stream_ids`` (S,) right after states:

        rollout(states, frame0, stream_ids, dets, masks, crops[, warps])

    With ``emb_priority`` the rollout takes the same, and after
    stream_ids the previous frame's dets (S, N, C) and mask (S, N) (a
    zero mask: no previous observations); it returns
    ``((states, (dets, mask) of its last frame), outs)`` so the novelty
    baseline carries across calls.

    With ``cmc_fn`` (a batched estimator such as
    motion/cmc.py::ecc_jax_batch or sof_jax_batch: (S, h, w) previous and
    current grayscale frames -> ((S, 2, 3) warps, (S,) ok)) the warp leg
    is live camera motion: the rollout takes grayscale frames
    (T, S, h, w) in place of warps, estimates each frame's S warps from
    the previous frame before the tracker step, and rescales their
    translations by 1 / ``cmc_scale``, the factor the frames were
    downscaled by (ecc.cpp:70-80). It then takes the previous frame
    (S, h, w) and a ``has_prev`` bool (the first frame ever gets the
    identity) after the leading arguments above, and returns
    ``((states[, (dets, mask)], last frame, True), outs)``:

        rollout(states[, frame0, stream_ids[, prev_dets, prev_masks]],
                prev_frame, has_prev, dets, masks[, crops], frames)
    """
    use_cmc = cmc_fn is not None
    if use_cmc and with_warps:
        raise ValueError("cmc_fn replaces the warps input; do not set both")
    if crop_budget is not None and embed_fn is None:
        raise ValueError("crop_budget requires embed_fn (live ReID)")
    if emb_cadence is not None:
        if embed_fn is None:
            raise ValueError("emb_cadence requires embed_fn (live ReID)")
        if int(emb_cadence) < 1:
            raise ValueError(f"emb_cadence must be >= 1, got {emb_cadence}")
    with_embs = with_embs or embed_fn is not None
    k_cad = int(emb_cadence) if emb_cadence is not None else 1
    if emb_priority:
        if crop_budget is None:
            raise ValueError(
                "emb_priority needs crop_budget (it chooses which crops "
                "fill the budget)")
        if k_cad > 1:
            raise ValueError(
                "emb_priority replaces emb_cadence (its rotation term "
                "subsumes the cadence refresh); set one or the other")
    # JAX multiplies by the float32 1 / cmc_scale (6.6666665 at 0.15),
    # which rounds otherwise than a division by cmc_scale
    inv_scale = float(np.float32(1.0 / float(cmc_scale)))

    def _embed(crops, d, m, t, stream_ids, prev):
        from motcpp_tpu_torch.appearance.reid import embed_valid_crops

        budget = crop_budget
        priority = None
        if emb_priority:
            priority = embedding_priority(d, m, *prev, t, rot=priority_rot)
        elif k_cad > 1:
            S, N = m.shape
            gate = ((t + stream_ids) % k_cad) == 0  # (S,)
            m = m & gate[:, None]
            auto = -(-S // k_cad) * N  # at most ceil(S/k) streams gated
            budget = min(budget, auto) if budget is not None else auto
        return embed_valid_crops(embed_fn, crops, d, m, budget=budget,
                                 priority=priority)

    def _live_warp(prev_frame, has_prev, frame):
        """(S, 2, 3) warps from the previous frame to ``frame``; the
        identity while there is no previous frame (the first-frame
        contract of every host estimator, ecc.cpp:40-46)."""
        if not has_prev:
            return torch.eye(2, 3, device=frame.device).expand(
                frame.shape[0], 2, 3)
        w, _ = cmc_fn(prev_frame, frame)
        if cmc_scale != 1.0:
            w = torch.cat([w[..., :2], w[..., 2:] * inv_scale], -1)
        return w

    def run_frames(states, dets, masks, extra, frame0, stream_ids, prev=None,
                   cmc=None):
        outs, out_masks = [], []
        for t in range(dets.shape[0]):
            d, m = dets[t], masks[t]
            args = [d, m]
            rest = [x[t] for x in extra]
            if with_embs:
                e = rest.pop(0)
                if embed_fn is not None:
                    e = _embed(e, d, m, frame0 + t, stream_ids, prev)
                args.append(e)
            prev = (d, m)
            if use_cmc:
                frame = rest.pop(0)
                warp = _live_warp(*cmc, frame)
                cmc = (frame, True)
            elif with_warps:
                warp = rest.pop(0)
            if use_cmc or with_warps:
                if not with_embs:
                    args.append(None)
                args.append(warp)
            states, (out, out_mask) = step_fn(states, *args)
            outs.append(out)
            out_masks.append(out_mask)
        return states, (torch.stack(outs), torch.stack(out_masks)), prev, cmc

    def split_cmc(rest):
        """(prev frame, has_prev) and the time-major arguments."""
        if use_cmc:
            return (rest[0], bool(rest[1])), rest[2:]
        return None, rest

    def carry(states, prev, cmc):
        tail = ((prev,) if emb_priority else ()) + (cmc if use_cmc else ())
        return (states,) + tail if tail else states

    def rollout(states, *rest):
        cmc, (dets, masks, *extra) = split_cmc(rest)
        states, outs, _, cmc = run_frames(states, dets, masks, extra, 0,
                                          None, cmc=cmc)
        return carry(states, None, cmc), outs

    def rollout_cadence(states, frame0, stream_ids, *rest):
        cmc, (dets, masks, *extra) = split_cmc(rest)
        states, outs, _, cmc = run_frames(states, dets, masks, extra,
                                          int(frame0), stream_ids, cmc=cmc)
        return carry(states, None, cmc), outs

    def rollout_priority(states, frame0, stream_ids, prev_dets, prev_masks,
                         *rest):
        cmc, (dets, masks, *extra) = split_cmc(rest)
        states, outs, prev, cmc = run_frames(states, dets, masks, extra,
                                             int(frame0), stream_ids,
                                             (prev_dets, prev_masks), cmc)
        return carry(states, prev, cmc), outs

    if emb_priority:
        return rollout_priority
    return rollout_cadence if k_cad > 1 else rollout


def _copy(states):
    return type(states)(*(t.clone() for t in states))


def state_to(states, device):
    """``states`` with every field on ``device`` (the fields already there
    are not copied)."""
    return type(states)(*(t.to(device) for t in states))


def shard_state(states, mesh: Mesh):
    """A state over all S streams as len(mesh) states over S / len(mesh)
    streams each, shard i on ``mesh[i]``."""
    fields = [shard_over_streams(mesh, t, t_leading=False) for t in states]
    return [type(states)(*(f[i] for f in fields)) for i in range(len(mesh))]


def gather_state(shards, device):
    """The per-shard states of :func:`shard_state` as one state over all
    streams on ``device`` (a new copy)."""
    return type(shards[0])(*(torch.cat([t.to(device) for t in field])
                             for field in zip(*shards)))


class MultiStreamRunner:
    """Runs S streams through a tracker step on one device, or sharded
    over ``devices``.

    Example:
        init_fn, step_fn = make_bytetrack(cfg, device="cuda")
        runner = MultiStreamRunner(init_fn, step_fn, n_streams=256)
        outs, out_masks = runner.run(dets, masks)  # (T,S,N,6), (T,S,N)

    Live ReID (appearance/reid.py::make_embed_fn): with ``embed_fn``
    run() takes raw uint8 crops (T, S, N, Hc, Wc, 3) as ``embs`` and
    the CNN runs per frame; ``crop_budget`` caps the crops embedded per
    frame, ``emb_priority`` fills that budget by
    :func:`embedding_priority` (the previous frame's detections carried
    across run() calls) and ``emb_cadence=k`` embeds each stream every
    k-th frame, staggered by stream, with the phase carried across run()
    calls. Live camera motion (motion/cmc.py::ecc_jax_batch or
    sof_jax_batch as ``cmc_fn``): run() takes grayscale frames
    (T, S, h, w) float32 at CMC scale (``cmc_scale``, 0.15 in the
    reference, cmc.cpp:8-26) as ``frames`` and each frame's warps are
    estimated on the device from the previous frame, which carries
    across run() calls (the first frame ever gets the identity). The
    state carries across ``run()`` calls until ``reset()``.

    Sharded (``devices``, a list of devices or a
    :class:`~motcpp_tpu_torch.parallel.collectives.Mesh`, which may name
    one device more than once): S must divide over the devices, and shard
    i runs streams ``[i*S/n, (i+1)*S/n)`` on ``devices[i]`` with the same
    step (whose constants follow its inputs' device) and ``embed_fn``
    (whose weights are copied to each device once). ``crop_budget`` is
    the global budget and must divide too: each shard embeds at most
    ``crop_budget // n`` crops a frame, as in the JAX package, so at a
    budget that binds a sharded runner does not equal a one-device one.
    The cadence and the priority use each shard's global stream ids, and
    each shard carries its own previous detections and frames. ``run()``
    takes its inputs on the host or on any device, launches every shard
    before it reads anything back, and returns the outputs concatenated
    along S on ``devices[0]``; ``init_states``, ``states``,
    ``set_states`` and ``run(states=...)`` speak the one-device state
    over all S streams (on ``devices[0]``), so a carry saved from a
    sharded runner loads into a one-device runner and the other way
    round. Without ``devices`` the runner runs on ``device``; given
    ``devices``, ``device`` must be left at its default or name
    ``devices[0]``.
    """

    def __init__(self, init_fn: Callable, step_fn: Callable, n_streams: int,
                 device="cuda", with_embs: bool = False,
                 with_warps: bool = False, embed_fn: Callable | None = None,
                 crop_budget: int | None = None,
                 emb_cadence: int | None = None, emb_priority: bool = False,
                 priority_rot: int = 8, cmc_fn: Callable | None = None,
                 cmc_scale: float = 1.0, devices=None):
        self.n_streams = int(n_streams)
        self.devices = None
        self._shards = None
        if devices is not None:
            self._init_shards(
                init_fn, step_fn, resolve_mesh(device, devices), dict(
                    with_embs=with_embs, with_warps=with_warps,
                    embed_fn=embed_fn, emb_cadence=emb_cadence,
                    emb_priority=emb_priority, priority_rot=priority_rot,
                    cmc_fn=cmc_fn, cmc_scale=cmc_scale), crop_budget)
            return
        self.device = resolve_device(device)
        self.with_embs = bool(with_embs) or embed_fn is not None
        self.with_warps = bool(with_warps)
        self.with_cmc = cmc_fn is not None
        self.emb_cadence = int(emb_cadence) if emb_cadence else 1
        self.emb_priority = bool(emb_priority)
        # cadence and priority share the frame phase (frame0, stream ids)
        self._use_phase = self.emb_cadence > 1 or self.emb_priority
        self._init_fn = init_fn
        self._rollout = make_rollout_general(
            step_fn, with_embs=self.with_embs, with_warps=self.with_warps,
            embed_fn=embed_fn, crop_budget=crop_budget,
            emb_cadence=emb_cadence, emb_priority=self.emb_priority,
            priority_rot=priority_rot, cmc_fn=cmc_fn, cmc_scale=cmc_scale)
        self._frame0 = 0
        self._first_stream = 0  # global id of stream 0 (a shard's offset)
        self._prev_dets = None  # priority mode: (dets, mask) of the last frame
        self._prev_frames = None  # live camera motion: the last frame
        self._states = None

    def _init_shards(self, init_fn, step_fn, mesh, kw, crop_budget):
        per_shard = mesh.shard_size(self.n_streams)
        if crop_budget is not None:
            if kw["embed_fn"] is None:
                raise ValueError("crop_budget requires embed_fn (live ReID)")
            crop_budget = mesh.shard_size(int(crop_budget), "crop_budget")
        self.devices = mesh
        self.device = mesh[0]
        self._init_fn = init_fn
        self._shards = []
        for i, dev in enumerate(mesh):
            shard = MultiStreamRunner(
                lambda S, dev=dev: state_to(init_fn(S), dev), step_fn,
                per_shard, device=dev, crop_budget=crop_budget, **kw)
            shard._first_stream = i * per_shard
            self._shards.append(shard)
        for attr in ("with_embs", "with_warps", "with_cmc", "emb_cadence",
                     "emb_priority"):
            setattr(self, attr, getattr(self._shards[0], attr))

    def init_states(self):
        if self._shards is not None:
            return state_to(self._init_fn(self.n_streams), self.device)
        return self._init_fn(self.n_streams)

    def run(self, dets, masks, embs=None, warps=None, states=None,
            frames=None, frame0=None):
        """Track T frames of all streams; returns (outs, out_masks) on the
        runner's device. embs (T, S, N, D), or crops under live ReID, is
        required iff the runner was built with embeddings; warps
        (T, S, 2, 3) iff with_warps; frames (T, S, h, w) iff with
        ``cmc_fn``. Without ``states`` the call continues from the
        carried state (and cadence phase and previous frame) and updates
        them; with ``states`` it is pure: the carried state, phase,
        previous detections and previous frame are left as they were,
        the phase is ``frame0`` (default 0), under ``emb_priority``
        every detection counts as novel on the first frame, and under
        live camera motion the first frame's warps come from the
        carried previous frame (as in the JAX package)."""
        if self._shards is not None:
            return self._run_shards(dets, masks, embs, warps, states,
                                    frames, frame0)
        if (embs is not None) != self.with_embs:
            raise ValueError(
                "pass embs iff the runner was built with embeddings")
        if (warps is not None) != self.with_warps:
            raise ValueError(
                "pass warps iff the runner was built with with_warps=True")
        if (frames is not None) != self.with_cmc:
            raise ValueError(
                "pass frames iff the runner was built with cmc_fn")
        if frame0 is not None and not self._use_phase:
            raise ValueError("frame0 only applies with emb_cadence set")
        dets = torch.as_tensor(dets, dtype=torch.float32, device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        if dets.dim() != 4 or dets.shape[1] != self.n_streams:
            raise ValueError(
                f"dets must be (T, {self.n_streams}, N, D), got "
                f"{tuple(dets.shape)}"
            )
        if masks.shape != dets.shape[:3]:
            raise ValueError(
                f"masks must be {tuple(dets.shape[:3])}, got "
                f"{tuple(masks.shape)}"
            )
        extra = []
        if embs is not None:
            embs = torch.as_tensor(embs, device=self.device)
            if tuple(embs.shape[:3]) != tuple(dets.shape[:3]):
                raise ValueError(
                    f"embs must lead with {tuple(dets.shape[:3])}, got "
                    f"{tuple(embs.shape)}")
            extra.append(embs)
        if frames is not None:
            frames = torch.as_tensor(frames, dtype=torch.float32,
                                     device=self.device)
            if frames.dim() != 4 or frames.shape[:2] != dets.shape[:2]:
                raise ValueError(
                    f"frames must be {tuple(dets.shape[:2])} + (h, w), got "
                    f"{tuple(frames.shape)}")
            extra.append(frames)
        if warps is not None:
            warps = torch.as_tensor(warps, dtype=torch.float32,
                                    device=self.device)
            if tuple(warps.shape) != tuple(dets.shape[:2]) + (2, 3):
                raise ValueError(
                    f"warps must be {tuple(dets.shape[:2]) + (2, 3)}, got "
                    f"{tuple(warps.shape)}")
            extra.append(warps)
        stateless = states is not None
        if stateless:
            states = _copy(states)
        elif self._states is not None:
            states = self._states
        else:
            states = self.init_states()
        lead = ()
        if self._use_phase:
            f0 = int(frame0 or 0) if stateless else self._frame0
            lead = (f0, torch.arange(self._first_stream,
                                     self._first_stream + self.n_streams,
                                     device=self.device))
            if self.emb_priority:
                prev = None if stateless else self._prev_dets
                if prev is None:  # no previous observations: all novel
                    prev = (torch.zeros_like(dets[0]),
                            torch.zeros_like(masks[0]))
                lead += prev
        if self.with_cmc:
            lead += (self._prev_frames, self._prev_frames is not None)
        carry, outs = self._rollout(states, *lead, dets, masks, *extra)
        if stateless:
            return outs
        if self.emb_priority or self.with_cmc:
            states, *tail = carry
            if self.emb_priority:
                self._prev_dets = tail.pop(0)
            if self.with_cmc:  # a copy: a view would hold all T frames
                self._prev_frames = tail[0].clone()
        else:
            states = carry
        if self._use_phase:
            self._frame0 += dets.shape[0]
        self._states = states
        return outs

    def _run_shards(self, dets, masks, embs, warps, states, frames, frame0):
        shape = tuple(np.shape(dets))
        if len(shape) != 4 or shape[1] != self.n_streams:
            raise ValueError(
                f"dets must be (T, {self.n_streams}, N, D), got {shape}")
        if tuple(np.shape(masks)) != shape[:3]:
            raise ValueError(
                f"masks must be {shape[:3]}, got {tuple(np.shape(masks))}")
        n = len(self._shards)
        legs = [[None] * n if x is None
                else shard_over_streams(self.devices, x)
                for x in (dets, masks, embs, warps, frames)]
        parts = [None] * n if states is None \
            else shard_state(states, self.devices)
        # every shard launched before any output is read back
        outs = [shard.run(d, m, embs=e, warps=w, states=st, frames=f,
                          frame0=frame0)
                for shard, d, m, e, w, f, st in zip(self._shards, *legs,
                                                    parts)]
        return tuple(torch.cat([o[i].to(self.device, non_blocking=True)
                                for o in outs], 1) for i in range(2))

    def set_states(self, states, frame0: int = 0):
        """Install a carried state (for example one restored from a
        checkpoint) and the cadence phase; later ``run()`` calls continue
        from them."""
        if self._shards is not None:
            for shard, part in zip(self._shards,
                                   shard_state(states, self.devices)):
                shard.set_states(part, frame0)
            return
        self._states = _copy(states)
        self._frame0 = int(frame0)

    @property
    def states(self):
        """A copy of the carried state, or None before the first run."""
        if self._shards is not None:
            if self._shards[0]._states is None:
                return None
            return gather_state([sh._states for sh in self._shards],
                                self.device)
        return None if self._states is None else _copy(self._states)

    def reset(self):
        if self._shards is not None:
            for shard in self._shards:
                shard.reset()
            return
        self._states = None
        self._frame0 = 0
        self._prev_dets = None
        self._prev_frames = None
