#!/usr/bin/env python3
"""Serving tick-latency distribution under sustained load.

Counterpart of the JAX package's ``scripts/serving_latency.py``. Drives
a :class:`motcpp_tpu_torch.serving.TrackingService` end to end (producer
threads submit frames through the native mux while the serving loop
ticks) and reports the wall-clock latency distribution of
``service.step()`` (host assemble + device step + fetch): p50 / p90 /
p95 / p99 / max, and the streams the p99 tick sustains at 30 FPS.

``--device-data`` serves a ring of tick inputs staged on the device
instead (the service takes device tensors from a mux as they are), so
the tick is timed without host ingest. ``--pipeline`` keeps
``--pipeline-depth`` ticks in flight (``step_async``) and reports the
interval between resolved ticks, with each tick's dispatch-to-fetch
time beside it.

Usage:
  python -m motcpp_tpu_torch.scripts.serving_latency --tracker bytetrack --streams 1024
  python -m motcpp_tpu_torch.scripts.serving_latency --occupancy 0.5   # half the slots live
  python -m motcpp_tpu_torch.scripts.serving_latency --cpu             # on the CPU

It runs on the CUDA device and raises without one unless given
``--cpu``; ``--lap auction_pallas`` (the default) is the auction CUDA
kernel there and its plain version on the CPU. The last line of the
output is the result row, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

MOTION_ONLY = ("sort", "bytetrack", "ocsort", "ucmctrack")
CROP_HW, REID_DIM = (256, 128), 512


def synth_frame(rng, n_obj, max_dets):
    """One frame of MOT17-like detections: (n, 6) float32."""
    n = min(n_obj, max_dets)
    cx = rng.uniform(60, 1860, n)
    cy = rng.uniform(60, 1020, n)
    w = rng.uniform(30, 120, n)
    h = rng.uniform(60, 260, n)
    d = np.zeros((n, 6), np.float32)
    d[:, 0] = cx - w / 2
    d[:, 1] = cy - h / 2
    d[:, 2] = cx + w / 2
    d[:, 3] = cy + h / 2
    d[:, 4] = rng.uniform(0.3, 1.0, n)
    return d


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--tracker", default="bytetrack")
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--max-dets", type=int, default=32)
    ap.add_argument("--max-tracks", type=int, default=64)
    ap.add_argument("--objects", type=int, default=14,
                    help="detections per frame per stream")
    ap.add_argument("--ticks", type=int, default=200,
                    help="measured ticks (after warmup)")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--occupancy", type=float, default=1.0,
                    help="fraction of slots with a live producer")
    ap.add_argument("--producers", type=int, default=4,
                    help="feeder threads sharing the attached streams")
    ap.add_argument("--lap", default="auction_pallas",
                    choices=["jv", "auction", "auction_pallas"],
                    help="auction_pallas: the auction CUDA kernel (its "
                    "plain version on the CPU)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--live-reid", action="store_true",
                    help="producers submit raw uint8 crops; the service "
                    "embeds them on the device (OSNet) before association")
    ap.add_argument("--reid-variant", default="x1_0",
                    choices=["x1_0", "x0_75", "x0_5", "x0_25"])
    ap.add_argument("--emb-cadence", type=int, default=0,
                    help="embed each stream's crops only every k-th tick "
                    "(staggered per slot; 0/1 = every tick)")
    ap.add_argument("--reid-quant", action="store_true",
                    help="run the live-ReID CNN int8-quantized "
                    "(appearance/quant.py)")
    ap.add_argument("--crop-budget", type=int, default=0,
                    help="per-tick cap on crops embedded (0 = all slots)")
    ap.add_argument("--emb-priority", type=float, default=0.0,
                    help="priority-budgeted embedding: fill a CNN budget "
                    "of round(FRAC * streams * max_dets) crops by "
                    "novelty/crowding/rotation score")
    ap.add_argument("--device-data", action="store_true",
                    help="serve a ring of tick inputs staged on the "
                    "device instead of producer threads: the serving-step "
                    "latency with host ingest excluded")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="ticks in flight when --pipeline is set; outputs "
                    "resolve in order, and a frame's dispatch-to-fetch "
                    "time grows to about depth intervals")
    ap.add_argument("--pipeline", action="store_true",
                    help="dispatch tick t+1 before fetching tick t "
                    "(step_async): the reported latency is the interval "
                    "between resolved ticks, the e2e columns the "
                    "dispatch-to-fetch time")
    return ap


def build_embed(args, device):
    """The live-ReID embed of ``args`` on ``device``: seeded random
    osnet_<variant> weights, the module forward in bfloat16 on the card
    and float32 on the CPU, or the int8 forward under ``--reid-quant``."""
    from motcpp_tpu_torch.appearance import osnet as osnet_mod
    from motcpp_tpu_torch.appearance.reid import make_embed_fn

    model = osnet_mod.init_params(getattr(
        osnet_mod, f"osnet_{args.reid_variant}")(feature_dim=REID_DIM), 0)
    if args.reid_quant:
        from motcpp_tpu_torch.appearance.quant import make_embed_fn_int8

        return make_embed_fn_int8(model, device=device)
    cdt = "float32" if device.type == "cpu" else "bfloat16"
    return make_embed_fn(model, compute_dtype=cdt, device=device)


def staged_frames(R, S, N, n_obj):
    """The ``--device-data`` ring's detections: R ticks of S streams,
    (R, S, N, 6) float32 and (R, S, N) bool, drawn from
    ``default_rng(0)`` by :func:`synth_frame` in the JAX harness's
    order."""
    rng = np.random.default_rng(0)
    dets = np.zeros((R, S, N, 6), np.float32)
    mask = np.zeros((R, S, N), bool)
    for r in range(R):
        for s in range(S):
            d = synth_frame(rng, n_obj, N)
            dets[r, s, : len(d)] = d
            mask[r, s, : len(d)] = True
    return dets, mask


def ring_length(emb_cadence: int) -> int:
    """8 staged ticks, or a multiple of a cadence > 1, so that the
    compacted crops' schedule matches the staged entries."""
    if emb_cadence > 1:
        return emb_cadence * max(1, -(-8 // emb_cadence))
    return 8


class DeviceRingMux:
    """The mux's ``assemble()`` over a ring of staged tick inputs:
    ``ring`` holds (dets, mask, crops or None) tensors on the device,
    handed out in turn and never written. Every one of the ``n_live``
    first slots is present every tick."""

    def __init__(self, ring, n_streams: int, n_live: int, device):
        self.ring = ring
        self.t = 0
        self.n_live = n_live
        self.warps = torch.eye(2, 3, device=device).expand(n_streams, 2, 3)
        self.present = np.zeros(n_streams, bool)
        self.present[:n_live] = True

    def assemble(self):
        dets, mask, crops = self.ring[self.t % len(self.ring)]
        self.t += 1
        return dets, mask, None, self.warps, self.present, crops

    def stats(self) -> dict:
        return {"submitted": self.t * self.n_live, "dropped": 0,
                "assembled": self.t, "attached": self.n_live}


def device_ring(args, crop_hw, device):
    """R staged tick inputs on ``device``: :func:`staged_frames`' dets
    and masks, and under live ReID (S, N, Hc, Wc, 3) uint8 crops drawn
    on the device by ``torch.randint`` from a generator seeded with the
    entry's index."""
    S, N = args.streams, args.max_dets
    R = ring_length(args.emb_cadence)
    dets, mask = staged_frames(R, S, N, args.objects)
    ring = []
    for r in range(R):
        crops = None
        if crop_hw is not None:
            gen = torch.Generator(device=device).manual_seed(r)
            crops = torch.randint(0, 255, (S, N) + crop_hw + (3,),
                                  generator=gen, dtype=torch.uint8,
                                  device=device)
        ring.append((torch.from_numpy(dets[r]).to(device),
                     torch.from_numpy(mask[r]).to(device), crops))
    return ring


def metric_name(args) -> str:
    """``torch_`` + the JAX harness's metric for the same flags."""
    return ("torch_" + f"{args.tracker}"
            + ("_livereid" if args.live_reid else "")
            + (f"_{args.reid_variant}" if args.live_reid
               and args.reid_variant != "x1_0" else "")
            + ("_int8" if args.live_reid and args.reid_quant else "")
            + (f"_cb{args.crop_budget}" if args.crop_budget else "")
            + (f"_pb{args.emb_priority:g}" if args.emb_priority else "")
            + (f"_ec{args.emb_cadence}" if args.emb_cadence > 1 else "")
            + ("_pipelined" if args.pipeline else "")
            + (f"_pd{args.pipeline_depth}" if args.pipeline
               and args.pipeline_depth != 2 else "")
            + ("_devdata" if args.device_data else "")
            + "_serving_tick_latency_ms")


def card_power_limit() -> str:
    """The first card's power limit as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def measure(args, embed=None, report: dict | None = None) -> dict:
    """Drive the service as ``args`` say and return the result row.

    ``embed``: a live-ReID embed made by :func:`build_embed` for these
    args, reused in place of a new one (the SLO sweep builds it once).
    ``report``, if given, receives what the row does not carry:
    ``native_mux`` (the service was built on the native mux), ``live``,
    ``presents`` (present streams of every resolved tick, warm-up and
    drain included) and ``stats`` (the service's counters at the end).
    """
    from motcpp_tpu_torch.device import resolve_device
    from motcpp_tpu_torch.serving import StreamMux, TrackingService

    if args.live_reid and args.tracker in MOTION_ONLY:
        raise ValueError(
            "--live-reid needs an appearance tracker (strongsort/botsort/"
            f"deepocsort/boosttrack/hybridsort), got {args.tracker}")
    device = torch.device("cpu") if args.cpu else resolve_device("cuda")
    n_live = max(1, int(round(args.streams * args.occupancy)))
    crop_hw = None
    reid_kw = {}
    if args.live_reid:
        crop_hw = CROP_HW
        budget = args.crop_budget or 0
        if args.emb_priority:
            # bench.py DEPLOYED's arithmetic: a fraction of the det-slot
            # capacity, filled by the novelty/crowding/rotation score
            budget = max(budget, int(round(
                args.emb_priority * args.streams * args.max_dets)))
        reid_kw = dict(crop_hw=crop_hw,
                       embed_fn=embed or build_embed(args, device),
                       crop_budget=budget or None,
                       emb_cadence=args.emb_cadence or None,
                       emb_priority=bool(args.emb_priority))
    svc = TrackingService.from_tracker(
        args.tracker, n_streams=args.streams, max_dets=args.max_dets,
        emb_dim=REID_DIM if args.live_reid else 0,
        tracker_kw=dict(max_tracks=args.max_tracks, lap_impl=args.lap),
        device=device, **reid_kw,
    )
    native = isinstance(svc.mux, StreamMux)
    handles = [svc.attach() for _ in range(n_live)]

    if args.device_data:
        # the staged inputs replace the mux behind its assemble()
        # contract; the service takes the device tensors as they are
        mux = svc.mux
        svc.mux = DeviceRingMux(device_ring(args, crop_hw, device),
                                args.streams, n_live, device)
        mux.close()
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # staged before timing starts

    # Producers: each thread owns a disjoint slice of the live streams
    # and submits one frame per stream per tick "generation". A shared
    # epoch counter (bumped by the measuring loop) paces them, so the
    # queue depth stays bounded at ~1 regardless of tick latency. They
    # and fill() block on one condition, not on polls, so that no idle
    # thread wakes to contend with the serving loop for the interpreter.
    paced = threading.Condition()
    state = {"epoch": 0, "queued": 0, "stop": False}
    started = threading.Barrier(args.producers + 1)

    def feeder(tid):
        rng = np.random.default_rng(1000 + tid)
        mine = handles[tid::args.producers]
        started.wait()
        seen = 0
        # a pool of crops served as rotating contiguous copies: distinct
        # bytes each tick at a camera's memcpy cost
        pool = None
        if crop_hw is not None:
            pool = rng.integers(
                0, 255, (args.max_dets * 4,) + crop_hw + (3,)
            ).astype(np.uint8)
        while True:
            with paced:
                paced.wait_for(
                    lambda: state["stop"] or state["epoch"] != seen)
                if state["stop"]:
                    return
                e = seen = state["epoch"]
            for j, h in enumerate(mine):
                d = synth_frame(rng, args.objects, args.max_dets)
                crops = None
                if pool is not None:
                    o = (e + j) % (pool.shape[0] - d.shape[0])
                    crops = pool[o:o + d.shape[0]].copy()
                svc.submit(h, d, crops=crops)
            with paced:
                state["queued"] += len(mine)
                paced.notify_all()

    if args.device_data:
        threads = []

        def fill():  # inputs are staged; nothing to feed
            pass
    else:
        threads = [threading.Thread(target=feeder, args=(t,), daemon=True)
                   for t in range(args.producers)]
        for t in threads:
            t.start()
        started.wait()

        def fill():
            # wait until every live stream has this epoch's frame queued
            with paced:
                state["epoch"] += 1
                want = state["epoch"] * n_live
                paced.notify_all()
                paced.wait_for(lambda: state["queued"] >= want,
                               timeout=30.0)

    presents = []

    def resolve(pending):
        batch = pending.result()
        presents.append(int(batch.present.sum()))
        return batch

    try:
        print(f"# warmup ({args.warmup} ticks, includes the kernel builds)"
              "...", file=sys.stderr, flush=True)
        for _ in range(args.warmup):
            fill()
            resolve(svc.step_async())

        lat = np.empty(args.ticks, np.float64)
        e2e = np.empty(args.ticks, np.float64)
        if args.pipeline:
            # depth D ticks in flight: the SLO figure is the interval
            # between resolved ticks; a frame's dispatch-to-fetch time
            # is about D intervals and reported beside it
            depth = max(2, args.pipeline_depth)
            pend = deque()
            for _ in range(depth):
                fill()
                pend.append((svc.step_async(), time.perf_counter()))
            last = time.perf_counter()
            for i in range(args.ticks):
                fill()  # producers queue ahead while the device computes
                pend.append((svc.step_async(), time.perf_counter()))
                p, t0 = pend.popleft()
                resolve(p)
                now = time.perf_counter()
                lat[i] = now - last
                e2e[i] = now - t0
                last = now
            while pend:  # drain the ticks in flight
                resolve(pend.popleft()[0])
        else:
            for i in range(args.ticks):
                fill()
                t0 = time.perf_counter()
                resolve(svc.step_async())
                lat[i] = e2e[i] = time.perf_counter() - t0
    finally:
        with paced:
            state["stop"] = True
            paced.notify_all()
        for t in threads:
            t.join(timeout=5)
    if report is not None:
        report.update(native_mux=native, live=n_live, presents=presents,
                      stats=svc.stats())

    ms = np.sort(lat) * 1e3
    q = lambda p: float(np.percentile(ms, p))  # noqa: E731
    p50, p90, p95, p99 = q(50), q(90), q(95), q(99)
    mean = float(ms.mean())
    # capacity at the tail: streams sustainable at 30 FPS if every tick
    # took as long as the p99 tick
    cap_p99 = n_live / (p99 * 1e-3) / 30.0
    kind = ("cpu" if device.type == "cpu"
            else torch.cuda.get_device_name(device))
    result = {
        "metric": metric_name(args),
        "p50": round(p50, 2), "p90": round(p90, 2),
        "p95": round(p95, 2), "p99": round(p99, 2),
        "max": round(float(ms[-1]), 2), "mean": round(mean, 2),
        "e2e_p50_ms": round(float(np.percentile(e2e * 1e3, 50)), 2),
        "e2e_p99_ms": round(float(np.percentile(e2e * 1e3, 99)), 2),
        "streams": args.streams, "live": n_live,
        "occupancy": args.occupancy,
        "ticks": args.ticks, "producers": args.producers,
        "lap": args.lap, "device": kind,
        "streams_at_30fps_at_p99": round(cap_p99, 1),
    }
    if device.type == "cuda":
        result["power_limit"] = card_power_limit()
    print(
        f"# [{args.tracker}] {kind}: tick latency "
        f"p50={p50:.2f} p90={p90:.2f} p95={p95:.2f} p99={p99:.2f} "
        f"max={ms[-1]:.2f} ms (mean {mean:.2f}) over {args.ticks} ticks, "
        f"{n_live}/{args.streams} live streams, {args.producers} "
        f"producer threads; p99-capacity {cap_p99:,.0f} streams@30FPS",
        file=sys.stderr, flush=True,
    )
    return result


def main(argv=None):
    print(json.dumps(measure(parser().parse_args(argv))))


if __name__ == "__main__":
    main()
