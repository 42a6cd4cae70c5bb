"""TrackingService: a continuous multi-stream serving loop on one device.

Counterpart of ``motcpp_tpu/serving/service.py``. Glue between the
ingest runtime (:mod:`motcpp_tpu_torch.serving.mux`, native C++ frame
queues) and the stream-batched tracker step: producers attach stream
slots and submit frames from any thread; each
:meth:`TrackingService.step` assembles one fixed-shape batch, runs ONE
tracker step over all S slots on the device, and returns the
per-stream emissions.

Exact per-stream semantics under irregular arrival:

* the step always runs all S slots, but slots with no queued frame this
  tick are selected back to their previous state, so an absent stream's
  tracks do not age, its frame counter does not advance, and its next
  frame continues bit-exactly where it left off. This holds because no
  tracker step writes into a tensor of the state it is given (each
  builds new tensors, or writes into its own clones);
* a freshly attached slot is re-initialised by the same select, so a
  recycled slot starts from a clean state (fresh ids).

The reference has no serving layer; its concurrency story is one
tracker instance per thread (reference: docs/guides/architecture.md:
246-258). This module is that story's batched equivalent: the threads
only move frames; one device steps every stream at once.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.serving.mux import create_mux


@dataclasses.dataclass(frozen=True)
class StreamHandle:
    """Capability to submit frames for one attached stream."""

    slot: int
    generation: int


@dataclasses.dataclass(frozen=True)
class ServedBatch:
    """Result of one service tick.

    present: (S,) bool, streams that consumed a frame this tick.
    outs: (S, K, 8) float32, [x1, y1, x2, y2, id, conf, cls, det_ind].
    out_masks: (S, K) bool, valid emission rows (false wherever
        present is false).
    """

    present: np.ndarray
    outs: np.ndarray
    out_masks: np.ndarray

    def tracks_for(self, handle: StreamHandle) -> np.ndarray:
        """(M, 8) emissions for one stream this tick (empty if absent)."""
        m = self.out_masks[handle.slot]
        return self.outs[handle.slot][m]


@dataclasses.dataclass
class PendingBatch:
    """In-flight tick from :meth:`TrackingService.step_async`.

    Holds the tick's output tensors on the device; ``result()`` copies
    them to the host (waiting for the device) and returns the
    :class:`ServedBatch`. Dispatching tick t+1 before resolving tick t
    lets the next tick's host work and transfers overlap this tick's
    device work."""

    present: np.ndarray
    _outs: Any
    _out_masks: Any
    _t0: float
    _svc_ref: Any

    def result(self) -> ServedBatch:
        batch = ServedBatch(
            present=self.present,
            outs=self._outs.cpu().numpy(),
            out_masks=self._out_masks.cpu().numpy(),
        )
        self._svc_ref._record_tick(self._t0, batch)
        return batch


def _sel(mask, a, b):
    """Per stream: ``a`` where ``mask`` (S,), else ``b``."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


def make_service_step(init_fn: Callable, step_fn: Callable, with_embs: bool,
                      with_warps: bool = False,
                      embed_fn: Callable | None = None,
                      crop_budget: int | None = None,
                      emb_cadence: int | None = None,
                      emb_priority: bool = False,
                      priority_rot: int = 8,
                      compact_crops: bool = False):
    """Build the present/reset-gated step over all slots.

    Returns ``svc(states, dets, masks, present, reset[, embs][, warps])
    -> (states, (outs, out_masks))``, every input with a leading S axis;
    ``init_fn(S)`` and ``step_fn`` are a tracker's stream-batched pair
    (``make_<tracker>(cfg)``). ``reset`` slots are re-initialised BEFORE
    the step (fresh attach); ``~present`` slots keep their previous
    state AFTER it (absent stream: the step still runs, its writes are
    discarded).

    With ``embed_fn`` (appearance/reid.py::make_embed_fn) the embedding
    input is raw uint8 crops (S, N, Hc, Wc, 3) and the ReID CNN runs on
    the device before the tracker step, over at most ``crop_budget``
    valid crops (appearance/reid.py::embed_valid_crops).

    emb_cadence=k (live ReID only): embed each stream's crops only on
    ticks where ``(tick + slot) % k == 0``. The svc then takes two more
    arguments after ``reset``: ``tick`` (an int) and ``stream_ids``
    ((S,) slot ids on the device). With ``emb_priority`` it takes the
    same, then the previous tick's dets (S, N, 6) and masks (S, N), and
    the budget is filled by parallel/streams.py::embedding_priority.

    compact_crops (cadence only): the crops input holds only the slots
    scheduled this tick, (S//k, n, Hc, Wc, 3) in slot order, and is
    scattered back to the full (S, n, ...) layout on the device. With
    ``stream_ids`` the service's 0..S-1 (S divisible by k), the
    scheduled slots are every k-th slot from ``(-tick) % k``: the
    schedule is exact, computed from the host's ``tick``, so no value is
    read back from the device. The embeddings are bit-identical to the
    full transfer's.
    """
    use_cadence = emb_cadence is not None and int(emb_cadence) > 1
    if use_cadence and embed_fn is None:
        raise ValueError("emb_cadence requires live ReID (embed_fn)")
    if emb_priority:
        if crop_budget is None or embed_fn is None:
            raise ValueError("emb_priority requires live ReID with a "
                             "crop_budget (it chooses WHICH crops fill "
                             "the budget)")
        if use_cadence:
            raise ValueError("emb_priority replaces emb_cadence; set one")
    use_adv = use_cadence or emb_priority
    k_cad = int(emb_cadence) if emb_cadence else 1

    def svc(states, dets, masks, present, reset, *extra):
        if use_adv:
            tick, stream_ids, *extra = extra
        prev_dm = None
        if emb_priority:
            prev_dm, extra = extra[:2], extra[2:]
        extra = list(extra)
        S, N = masks.shape
        states = type(states)(*(_sel(reset, f, s)
                                for f, s in zip(init_fn(S), states)))
        # ingest conditioning: a serving boundary cannot trust its
        # producers; non-finite detection rows are masked off
        masks = masks & present[:, None] & torch.isfinite(dets).all(-1)
        if with_embs and embed_fn is None and extra:
            e = extra[0]
            extra[0] = torch.where(torch.isfinite(e).all(-1, keepdim=True),
                                   e, 0.0)
        if with_warps:
            w = extra[-1]
            w_ok = torch.isfinite(w).flatten(1).all(1)[:, None, None]
            extra[-1] = torch.where(w_ok, w, torch.eye(2, 3, dtype=w.dtype,
                                                       device=w.device))
        if with_embs and embed_fn is not None:
            from motcpp_tpu_torch.appearance.reid import embed_valid_crops

            emb_masks, budget, pri = masks, crop_budget, None
            crops_in = extra[0]
            if emb_priority:
                from motcpp_tpu_torch.parallel.streams import (
                    embedding_priority,
                )

                pri = embedding_priority(dets, emb_masks, *prev_dm, tick,
                                         rot=priority_rot)
            if use_cadence:
                gate = ((tick + stream_ids) % k_cad) == 0  # (S,)
                emb_masks = masks & gate[:, None]
                auto = -(-S // k_cad) * N
                budget = min(budget, auto) if budget is not None else auto
                if compact_crops:
                    full = torch.zeros((S // k_cad, k_cad)
                                       + tuple(crops_in.shape[1:]),
                                       dtype=crops_in.dtype,
                                       device=crops_in.device)
                    full[:, (-tick) % k_cad] = crops_in
                    crops_in = full.reshape((S,) + tuple(crops_in.shape[1:]))
            extra[0] = embed_valid_crops(embed_fn, crops_in, dets, emb_masks,
                                         budget=budget, priority=pri)
        if with_warps and not with_embs:
            extra.insert(0, None)
        new_states, (outs, out_masks) = step_fn(states, dets, masks, *extra)
        merged = type(states)(*(_sel(present, n, o)
                                for n, o in zip(new_states, states)))
        # emission guard: rows whose box went non-finite (a zero-area
        # detection NaN-ing the XYAH aspect state, which the reference's
        # ByteTrack reproduces) are masked out of the serving output;
        # the track itself ages out through the normal lifecycle
        out_masks = (out_masks & present[:, None]
                     & torch.isfinite(outs).all(-1))
        return merged, (outs, out_masks)

    return svc


class TrackingService:
    """Continuous tracking over dynamically attached streams, on one
    device.

    Example:
        svc = TrackingService.from_tracker("bytetrack", n_streams=64)
        cam = svc.attach()
        svc.submit(cam, dets)            # any thread
        batch = svc.step()               # the serving loop
        rows = batch.tracks_for(cam)

    Args:
        init_fn / step_fn: a tracker's stream-batched pair
            (``make_<tracker>(cfg, device=...)``) on ``device``.
        n_streams: S slots.
        max_dets: N detection slots per frame.
        emb_dim: per-detection embedding width (0 = motion-only).
        queue_depth: per-slot frame queue; overflow drops the oldest.
        device: where the state lives and the step runs (default
            ``"cuda"``; raises where there is none, ``"cpu"`` runs on
            the CPU).

    One device only: the JAX service's ``devices`` and its stream
    sharding over a mesh are not ported (ROADMAP.md queue 1, item 15).
    """

    def __init__(self, init_fn: Callable, step_fn: Callable, n_streams: int,
                 max_dets: int = 32, emb_dim: int = 0, queue_depth: int = 4,
                 device="cuda", prefer_native_mux: bool = True,
                 with_warps: bool = False, crop_hw: tuple | None = None,
                 embed_fn: Callable | None = None,
                 crop_budget: int | None = None,
                 emb_cadence: int | None = None,
                 emb_priority: bool = False,
                 priority_rot: int = 8,
                 cadence_compact: bool | None = None):
        """crop_hw + embed_fn switch the service to LIVE ReID: producers
        submit raw (n, Hc, Wc, 3) uint8 detection crops instead of
        embeddings (the mux carries them natively), and the CNN runs on
        the device each tick. emb_dim must then be the embed feature
        width (the tracker cfg's emb_dim).

        crop_budget: per-tick cap on the crops the CNN embeds
        (appearance/reid.py::embed_valid_crops): ticks with more valid
        detections embed the highest-confidence ones and let the rest
        associate by motion only.

        emb_cadence=k: embed each stream's crops only every k-th tick,
        staggered per slot (see make_service_step).

        emb_priority=True (requires crop_budget): fill the per-tick CNN
        budget by parallel/streams.py::embedding_priority. The service
        holds the previous tick's dets and masks (device copies, never
        the mux's buffers) and feeds them back each tick.

        cadence_compact: send only the scheduled slots' crops to the
        device each tick (k x fewer bytes, bit-identical output).
        Default None = on whenever n_streams divides by k; False forces
        the full transfer, True raises if the divisibility does not
        hold."""
        self.device = resolve_device(device)
        self.n_streams = int(n_streams)
        self.max_dets = int(max_dets)
        self.emb_dim = int(emb_dim)
        self.with_warps = bool(with_warps)
        self.crop_hw = tuple(int(x) for x in crop_hw) if crop_hw else None
        self._embed_fn = embed_fn
        if (embed_fn is None) != (self.crop_hw is None):
            raise ValueError("crop_hw and embed_fn go together")
        if embed_fn is not None and self.emb_dim <= 0:
            raise ValueError("live ReID needs emb_dim = feature width")
        if crop_budget is not None and embed_fn is None:
            raise ValueError("crop_budget requires live ReID "
                             "(crop_hw + embed_fn)")
        self.emb_cadence = int(emb_cadence) if emb_cadence else 1
        self._use_cadence = self.emb_cadence > 1
        if self._use_cadence and embed_fn is None:
            raise ValueError("emb_cadence requires live ReID "
                             "(crop_hw + embed_fn)")
        self.emb_priority = bool(emb_priority)
        if self.emb_priority and (crop_budget is None or embed_fn is None):
            raise ValueError("emb_priority requires live ReID with a "
                             "crop_budget")
        if self.emb_priority and self._use_cadence:
            raise ValueError("emb_priority replaces emb_cadence; set one")
        self._use_adv = self._use_cadence or self.emb_priority
        self._prev_dm = None  # previous tick's (dets, masks) for priority
        # compacted crop transfer: with cadence k, only the S/k slots
        # scheduled this tick send their crops; needs S divisible by k
        self._cad_compact = (self._use_cadence
                             and self.n_streams % self.emb_cadence == 0)
        if cadence_compact is not None:
            if cadence_compact and not self._cad_compact:
                raise ValueError(
                    "cadence_compact needs emb_cadence > 1 and n_streams "
                    f"to divide by it (n_streams={n_streams}, "
                    f"k={self.emb_cadence})"
                )
            self._cad_compact = bool(cadence_compact)
        self.mux = create_mux(
            self.n_streams, self.max_dets,
            # crops replace wire embeddings when live ReID is on
            0 if embed_fn is not None else self.emb_dim,
            queue_depth, prefer_native=prefer_native_mux,
            crop_hw=self.crop_hw,
        )
        self._init_fn = init_fn
        self._svc = make_service_step(
            init_fn, step_fn, with_embs=self.emb_dim > 0,
            with_warps=self.with_warps, embed_fn=embed_fn,
            crop_budget=crop_budget, emb_cadence=emb_cadence,
            emb_priority=self.emb_priority, priority_rot=priority_rot,
            compact_crops=self._cad_compact,
        )
        self._slot_ids = torch.arange(self.n_streams, device=self.device)
        self._states = None
        self._lock = threading.Lock()
        self._reset = np.zeros((self.n_streams,), bool)
        self._gen = np.zeros((self.n_streams,), np.int64)
        self._ticks = 0
        self._tick_ms_last = 0.0
        self._tick_ms_ewma = None
        self._tick_ms_max = 0.0
        self._last_present = 0

    @classmethod
    def from_tracker(cls, name: str, n_streams: int, max_dets: int = 32,
                     emb_dim: int = 0, tracker_kw: dict | None = None,
                     device="cuda", **service_kw):
        """Build a service from a tracker name ("bytetrack", "sort", ...)
        on ``device``.

        tracker_kw goes to the tracker's config dataclass (thresholds,
        max_tracks, lap_impl, ...); capacities are filled from the
        service arguments.
        """
        import importlib

        mod = importlib.import_module(f"motcpp_tpu_torch.models.{name}")
        make = getattr(mod, f"make_{name}")
        cfg_cls = next(
            (v for k, v in vars(mod).items() if k.lower() == f"{name}config"
             or k == {"ucmctrack": "UCMCConfig"}.get(name)),
            None,
        )
        if cfg_cls is None:
            raise ValueError(
                f"tracker module motcpp_tpu_torch.models.{name} has no "
                f"config class matching '{name}Config' (case-insensitive)"
            )
        kw = dict(tracker_kw or {})
        kw.setdefault("max_dets", max_dets)
        if emb_dim > 0 and "emb_dim" in cfg_cls.__dataclass_fields__:
            kw.setdefault("emb_dim", emb_dim)
        init_fn, step_fn = make(cfg_cls(**kw), device=device)
        return cls(init_fn, step_fn, n_streams=n_streams, max_dets=max_dets,
                   emb_dim=emb_dim, device=device, **service_kw)

    # ------------------------------------------------------------------
    def attach(self) -> StreamHandle:
        """Claim a slot for a new stream; its state is re-initialised on
        the next step (fresh ids, empty track table)."""
        slot, gen = self.mux.attach()
        with self._lock:
            self._reset[slot] = True
            self._gen[slot] = gen
        return StreamHandle(slot=slot, generation=gen)

    def detach(self, handle: StreamHandle) -> None:
        self._check(handle)
        self.mux.detach(handle.slot)

    def submit(self, handle: StreamHandle, dets, embs=None,
               warp=None, crops=None) -> int:
        """Queue one frame (thread-safe); returns the queue length.
        warp: optional (2, 3) camera warp for this frame, applied only
        when the service was built with with_warps=True. crops:
        (n, Hc, Wc, 3) uint8 detection crops, the live-ReID input when
        the service was built with crop_hw/embed_fn."""
        self._check(handle)
        return self.mux.submit(handle.slot, dets, embs, warp, crops)

    def pending(self, handle: StreamHandle) -> int:
        self._check(handle)
        return self.mux.pending(handle.slot)

    def _check(self, handle: StreamHandle) -> None:
        if self._gen[handle.slot] != handle.generation:
            raise ValueError(
                f"stale handle: slot {handle.slot} was re-attached "
                f"(generation {handle.generation} != "
                f"{int(self._gen[handle.slot])})"
            )

    # ------------------------------------------------------------------
    def step(self) -> ServedBatch:
        """Assemble one batch and run one tracker step over all slots."""
        return self.step_async().result()

    def step_async(self) -> PendingBatch:
        """Dispatch one tick without waiting for its outputs.

        Assembles the batch, starts its transfer to the device, launches
        the step and returns a :class:`PendingBatch`; call ``.result()``
        to fetch. Nothing here waits for the device: the transfers are
        asynchronous and no value is read back. States are sequenced by
        dispatch order, so interleaving is safe from one loop thread;
        outputs must be resolved in dispatch order."""
        t0 = time.perf_counter()
        dets, mask, embs, warps, present, crops = self.mux.assemble()
        with self._lock:
            reset = self._reset.copy()
            self._reset[:] = False
        if self._states is None:
            self._states = self._init_states()
        dets_d, mask_d = self._put(dets), self._put(mask)
        args = [dets_d, mask_d, self._put(present), self._put(reset)]
        if self._use_adv:
            args += [self._ticks, self._slot_ids]
        if self.emb_priority:
            args += self._prev_dm or [torch.zeros_like(dets_d),
                                      torch.zeros_like(mask_d)]
        if self._embed_fn is not None:
            rows = None
            if self._cad_compact:
                # the slots scheduled this tick, as make_service_step
                # derives them from the tick
                rows = np.arange((-self._ticks) % self.emb_cadence,
                                 self.n_streams, self.emb_cadence)
            args.append(self._put(crops, rows))
        elif self.emb_dim > 0:
            args.append(self._put(embs))
        if self.with_warps:
            args.append(self._put(warps))
        self._states, (outs, out_masks) = self._svc(self._states, *args)
        if self.emb_priority:
            self._prev_dm = [dets_d, mask_d]
        self._ticks += 1
        return PendingBatch(present=present, _outs=outs,
                            _out_masks=out_masks, _t0=t0, _svc_ref=self)

    def _put(self, a: np.ndarray, rows=None) -> torch.Tensor:
        """A copy of host array ``a`` (of its ``rows`` along axis 0) on
        the service's device, never a view of ``a``: the mux overwrites
        its batch buffers on the next assemble, so a tensor that aliased
        one would change under whoever holds it (the priority mode holds
        the previous tick's dets). On a CUDA device the copy goes through
        pinned memory with ``non_blocking=True``, so the dispatch does not
        wait for the device; PyTorch's pinned-memory cache hands the block
        out again only after that transfer has completed."""
        if self.device.type != "cuda":
            return torch.from_numpy(a.copy() if rows is None else a[rows])
        shape = a.shape if rows is None else (len(rows),) + a.shape[1:]
        buf = torch.empty(shape, dtype=torch.from_numpy(a[:0]).dtype,
                          pin_memory=True)
        if rows is None:
            np.copyto(buf.numpy(), a)
        else:
            np.take(a, rows, axis=0, out=buf.numpy())
        return buf.to(self.device, non_blocking=True)

    def _record_tick(self, t0: float, batch: ServedBatch) -> None:
        # wall time of the whole tick (assemble + step + fetch; for
        # pipelined callers the dispatch-to-fetch latency, which
        # overlapping ticks can stretch past the tick interval) and
        # slot occupancy, for stats()
        ms = (time.perf_counter() - t0) * 1e3
        self._tick_ms_last = ms
        self._tick_ms_max = max(self._tick_ms_max, ms)
        self._tick_ms_ewma = (
            ms if self._tick_ms_ewma is None
            else 0.95 * self._tick_ms_ewma + 0.05 * ms
        )
        self._last_present = int(batch.present.sum())

    def _conform(self, template, states, what: str):
        """``states`` as fresh tensors on the service's device, checked
        against ``template`` (same state type, same shape per field) and
        cast to its dtypes. Always a copy, so a caller's tensors never
        become the live carry."""
        if type(states) is not type(template):
            raise ValueError(
                f"{what} structure mismatch: expected "
                f"{type(template).__name__}{template._fields}, got "
                f"{type(states).__name__}"
                f"{getattr(states, '_fields', '')}"
            )
        out = []
        for name, t, s in zip(template._fields, template, states):
            if tuple(np.shape(s)) != tuple(t.shape):
                raise ValueError(
                    f"{what} shape mismatch in {name}: expected "
                    f"{tuple(t.shape)}, got {tuple(np.shape(s))}"
                )
            if isinstance(s, torch.Tensor):
                out.append(s.to(self.device, t.dtype, copy=True))
            else:
                out.append(torch.tensor(np.asarray(s), dtype=t.dtype,
                                        device=self.device))
        return type(template)(*out)

    def _init_states(self):
        """A fresh carry state over every slot on the service's device:
        the template that ``utils/checkpoint.py::load_state`` reads a
        checkpoint into."""
        return self._init_fn(self.n_streams)

    @property
    def states(self):
        """A copy of the carry state (a tracker state over n_streams
        slots), or None before the first step."""
        if self._states is None:
            return None
        return type(self._states)(*(t.clone() for t in self._states))

    def restore(self, states) -> None:
        """Install a carry state (failover / migration): a previous
        ``svc.states`` of a service of this tracker and size (or one read
        back from a file by ``utils/checkpoint.py::load_state``), with
        tensors or numpy arrays as fields. The fields are copied, never
        aliased. Stream continuation after restore is bit-exact. The
        restored state supersedes every pending attach-time reset, so a
        stream attached before the restore continues it; a slot attached
        after it starts fresh. (The JAX service leaves the flags set, and
        its failover test clears them by hand.)"""
        self._states = self._conform(self._init_states(), states, "state")
        with self._lock:
            self._reset[:] = False

    def export_stream(self, handle: StreamHandle):
        """Snapshot ONE stream's tracker state: the tracker's state type
        with one slot's host numpy arrays (no stream axis) as fields.

        The unit of rebalancing: a camera moves between services by
        export -> import, while every other slot keeps running.
        Continuation after import is bit-exact.
        """
        self._check(handle)
        if self._states is None:
            self._states = self._init_states()
        slot = handle.slot
        return type(self._states)(*(t[slot].to("cpu", copy=True).numpy()
                                    for t in self._states))

    def import_stream(self, handle: StreamHandle, snapshot) -> None:
        """Install an :meth:`export_stream` snapshot into this slot.

        The target slot should be freshly attached (or its previous
        stream's history is overwritten). Clears the slot's attach-time
        reset flag so the next step CONTINUES the imported stream
        instead of re-initialising it. Checked against a single-slot
        template; raises ValueError on a mismatch.
        """
        self._check(handle)
        one = self._init_fn(1)
        snap = self._conform(type(one)(*(t[0] for t in one)), snapshot,
                             "stream snapshot")
        if self._states is None:
            self._states = self._init_states()
        idx = torch.tensor([handle.slot], device=self.device)
        self._states = type(self._states)(*(
            full.index_put((idx,), s.unsqueeze(0))
            for full, s in zip(self._states, snap)))
        with self._lock:
            self._reset[handle.slot] = False

    def stats(self) -> dict:
        """Mux counters + tick-latency/occupancy gauges.

        submitted/dropped/assembled/attached come from the mux;
        tick_ms_{last,ewma,max} time the full tick (assemble + device
        step + fetch; ewma alpha = 0.05), and occupancy is the live-slot
        fraction of the latest tick.
        """
        s = self.mux.stats()
        s["ticks"] = self._ticks
        s["tick_ms_last"] = round(self._tick_ms_last, 3)
        s["tick_ms_ewma"] = (
            round(self._tick_ms_ewma, 3)
            if self._tick_ms_ewma is not None else 0.0
        )
        s["tick_ms_max"] = round(self._tick_ms_max, 3)
        s["occupancy"] = (
            self._last_present / self.n_streams if self.n_streams else 0.0
        )
        return s
