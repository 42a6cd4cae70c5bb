#!/usr/bin/env python3
"""Ablation-scale accuracy scoreboard: the nine trackers (eleven rows) on
the 600-frame calibrated synthetic scene
(``data/synthetic.py::ablation_scene``).

Counterpart of the JAX package's ``scripts/ablation_benchmark.py``: the
same rows at the same configurations, the same scene, the same cadence
and priority-budget probes, scored by the port's metrics with the same
rounding and the same progress line. The scene stands in for the MOT17
ablation split (out of reach without egress): 600 frames, 30-80
concurrent tracks, about 100 identities of entry and exit churn,
crossing occlusions, camera pan injected as ground-truth warps, detector
noise calibrated to the vendored FRCNN det files.

The tracker configurations mirror the reference eval tool's settings
(reference: tools/motcpp_eval.cpp:96-316); ``boosttrack-noreid`` and
``hybridsort-noreid`` are diagnostic rows (docs/accuracy.md).

Beside the JAX tool's arguments, ``device`` (the CUDA device by default;
``--cpu`` for the CPU) and ``--lap`` (the assignment solver the wrappers
take: the exact JV by default, as the JAX tool runs them, or the plain
auction, or ``auction_pallas``, the auction CUDA kernel on the card and
its plain version on the CPU). ``--write`` writes the plain scoreboard to
``motcpp_tpu_torch/_build/accuracy_ablation_torch.json``; the committed
tables under ``tests/`` are the JAX package's and are never written.

Usage:
  python -m motcpp_tpu_torch.scripts.ablation_benchmark [--frames 600] [--lap auction_pallas]
  python -m motcpp_tpu_torch.scripts.ablation_benchmark --cpu --frames 150 --trackers bytetrack
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS

# where --write puts the plain scoreboard
TABLE = (Path(__file__).resolve().parent.parent / "_build"
         / "accuracy_ablation_torch.json")

# eval-tool-parity configs (reference: tools/motcpp_eval.cpp:96-316);
# embeddings are fed to the same trackers the reference feeds FastReID
# embeddings to.
SCOREBOARD = {
    "sort": dict(kw={}, embs=False),
    "bytetrack": dict(kw=dict(frame_rate=30), embs=False),
    "ocsort": dict(kw={}, embs=False),
    "ucmctrack": dict(kw=dict(dt=1.0 / 30), embs=False),
    "deepocsort": dict(kw={}, embs=True),
    # the eval tool overrides StrongSORT's header defaults with the
    # Python-parity values min_conf=0.6, max_cos_dist=0.4
    # (motcpp_eval.cpp:210-212 vs strongsort.hpp:317-318); the header
    # defaults admit occlusion-noised embeddings into the tight 0.2
    # gate and 2.3x the ID switches on this scene (docs/accuracy.md)
    "strongsort": dict(kw=dict(min_conf=0.6, max_cos_dist=0.4), embs=True),
    "botsort": dict(kw=dict(with_reid=True), embs=True),
    "boosttrack": dict(
        kw=dict(use_rich_s=True, use_sb=True, use_vt=True, with_reid=True),
        embs=True,
    ),
    "boosttrack-noreid": dict(
        kw=dict(use_rich_s=True, use_sb=True, use_vt=True), embs=False,
        model="boosttrack",
    ),
    "hybridsort": dict(kw=dict(with_reid=True), embs=True),
    # the eval tool also overrides HybridSort's header defaults
    # (det_thresh 0.7 -> 0.5 "use track_thresh from Python",
    # iou_threshold 0.15 -> 0.3, motcpp_eval.cpp:286-289); under those
    # values the JAX package reproduces the reference binary's no-reid
    # row digit for digit (HOTA 78.69 / IDSW 30)
    "hybridsort-noreid": dict(
        kw=dict(with_reid=False, det_thresh=0.5, iou_threshold=0.3),
        embs=False, model="hybridsort",
    ),
}


def budget_select(d_now, prev_d, t, emb_budget, budget_policy="priority",
                  device="cuda"):
    """The detections of frame ``t`` (``d_now``, (n, 6) float32; ``prev_d``
    the previous frame's, or None) that keep their embeddings under
    ``emb_budget``: a boolean mask (n,) of the ``ceil(emb_budget * n)``
    highest by ``parallel/streams.py::embedding_priority`` on ``device``
    ("priority") or by confidence ("conf"). The previous frame's dets
    are padded to ``max(n, len(prev_d), 1)`` rows, as the JAX tool pads
    them for its fixed-shape function."""
    from motcpp_tpu_torch.parallel.streams import embedding_priority

    n = d_now.shape[0]
    C = max(1, int(np.ceil(emb_budget * n)))
    if budget_policy == "priority":
        pd = prev_d if prev_d is not None else np.zeros((0, 6), np.float32)
        pN = max(n, len(pd), 1)
        dpad = np.zeros((1, pN, 6), np.float32)
        dpad[0, :n] = d_now
        mpad = np.zeros((1, pN), bool)
        mpad[0, :n] = True
        ppad = np.zeros((1, pN, 6), np.float32)
        ppad[0, :len(pd)] = pd
        pmask = np.zeros((1, pN), bool)
        pmask[0, :len(pd)] = True
        dev = resolve_device(device)
        pri = embedding_priority(
            *(torch.from_numpy(a).to(dev) for a in (dpad, mpad, ppad, pmask)),
            t).cpu().numpy()[0, :n]
    else:
        pri = d_now[:, 4]
    sel = np.zeros(n, bool)
    sel[np.argsort(-pri)[:C]] = True
    return sel


def run_scoreboard(n_frames=600, trackers=None, progress=print,
                   pan_amp=None, use_warps=True, emb_cadence=1,
                   emb_budget=0.0, budget_policy="priority", device="cuda",
                   lap_impl=None):
    """Run every scoreboard row; returns {name: metrics-dict}.

    pan_amp/use_warps: the replica comparison runs on the no-pan scene
    (pan_amp=(0, 0)) without warp injection.

    emb_cadence=k: zero the detection embeddings except every k-th frame
    (the accuracy-cost probe for the live-ReID cadence); k=1 is the
    plain scoreboard.

    emb_budget=f in (0, 1): keep only ceil(f * n) detections' embeddings
    a frame, chosen by :func:`budget_select` under ``budget_policy``
    (the accuracy-cost probe for the priority-budgeted live ReID).

    device: where the trackers run (the CUDA device by default; it
    raises where there is none). lap_impl: None keeps each wrapper's
    default, the exact JV, as the JAX tool does; otherwise the wrappers'
    ``lap_impl`` ("auction", or "auction_pallas", the auction kernel)."""
    import motcpp_tpu_torch
    from motcpp_tpu_torch.data.synthetic import ablation_scene
    from motcpp_tpu_torch.metrics import (
        clear_metrics,
        hota_metrics,
        identity_metrics,
    )

    unknown = [t for t in (trackers or []) if t not in SCOREBOARD]
    if unknown:  # fail fast, before the expensive scene build
        raise SystemExit(
            f"unknown tracker(s) {unknown}; valid: {sorted(SCOREBOARD)}"
        )
    resolve_device(device)
    lap_kw = {} if lap_impl is None else dict(lap_impl=lap_impl)
    scene_kw = {} if pan_amp is None else dict(pan_amp=tuple(pan_amp))
    gt, dets, embs, warps = ablation_scene(n_frames=n_frames, **scene_kw)
    if not use_warps:
        warps = {t: None for t in warps}
    img = np.zeros((1080, 1920, 3), np.uint8)
    results = {}
    for name in trackers or SCOREBOARD:
        spec = SCOREBOARD[name]
        model = spec.get("model", name)
        tr = motcpp_tpu_torch.create_tracker(
            model, max_tracks=192, max_dets=96, device=device,
            **spec["kw"], **lap_kw
        )
        pred = {}
        t0 = time.time()
        prev_d = None
        for t in range(1, n_frames + 1):
            e = embs[t] if spec["embs"] else None
            if e is not None and emb_cadence > 1 and t % emb_cadence != 0:
                e = np.zeros_like(e)
            d_now = np.asarray(dets[t], np.float32).reshape(-1, 6)
            if e is not None and 0.0 < emb_budget < 1.0 and len(d_now):
                sel = budget_select(d_now, prev_d, t, emb_budget,
                                    budget_policy, device)
                e = np.where(sel[:, None], e, 0.0)
            prev_d = d_now
            out = tr.update(dets[t], img, e, warp=warps[t])
            if out.shape[0]:
                pred[t] = (
                    out[:, 4].astype(int),
                    out[:, :4].astype(float),
                    out[:, 5].astype(float),
                )
        c = clear_metrics(gt, pred)
        i = identity_metrics(gt, pred)
        h = hota_metrics(gt, pred)
        results[name] = {
            "HOTA": round(h["HOTA"], 2),
            "MOTA": round(c["MOTA"], 2),
            "IDF1": round(i["IDF1"], 2),
            "DetA": round(h["DetA"], 2),
            "AssA": round(h["AssA"], 2),
            "IDSW": int(c["IDSW"]),
            "MT": int(c["MT"]),
            "ML": int(c["ML"]),
            "FP": int(c["FP"]),
            "FN": int(c["FN"]),
        }
        m = results[name]
        progress(
            f"{name:18s} HOTA {m['HOTA']:6.2f} MOTA {m['MOTA']:6.2f} "
            f"IDF1 {m['IDF1']:6.2f} DetA {m['DetA']:6.2f} "
            f"AssA {m['AssA']:6.2f} IDSW {m['IDSW']:4d} MT {m['MT']:3d} "
            f"ML {m['ML']:3d}  ({time.time() - t0:.0f}s)"
        )
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--trackers", nargs="*", default=None)
    ap.add_argument("--write", action="store_true",
                    help=f"write {TABLE.name} under motcpp_tpu_torch/_build")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--lap", choices=IMPLS, default=None,
                    help="the trackers' assignment solver (default: each "
                    "wrapper's, the exact JV)")
    ap.add_argument("--emb-cadence", type=int, default=1,
                    help="zero det embeddings except every k-th frame "
                    "(accuracy-cost probe for the live-ReID serving "
                    "cadence; 1 = plain scoreboard)")
    ap.add_argument("--emb-budget", type=float, default=0.0,
                    help="keep only this fraction of detections' "
                    "embeddings per frame (accuracy-cost probe for the "
                    "priority-budgeted live-ReID CNN; 0 = off)")
    ap.add_argument("--budget-policy", default="priority",
                    choices=["priority", "conf"],
                    help="which dets fill the --emb-budget: the serving "
                    "embedding_priority score or plain confidence order")
    args = ap.parse_args(argv)

    if args.write and (args.emb_cadence > 1 or args.emb_budget):
        raise SystemExit("--write pins the PLAIN scoreboard; drop "
                         "--emb-cadence/--emb-budget")
    results = run_scoreboard(args.frames, args.trackers,
                             emb_cadence=args.emb_cadence,
                             emb_budget=args.emb_budget,
                             budget_policy=args.budget_policy,
                             device="cpu" if args.cpu else "cuda",
                             lap_impl=args.lap)
    if args.write:
        TABLE.parent.mkdir(parents=True, exist_ok=True)
        TABLE.write_text(json.dumps(results, indent=1) + "\n")
        print(f"wrote {TABLE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
