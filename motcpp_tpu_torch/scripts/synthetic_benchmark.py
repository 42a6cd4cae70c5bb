#!/usr/bin/env python3
"""Synthetic accuracy benchmark: all trackers on a generated scene.

Counterpart of the JAX package's ``scripts/synthetic_benchmark.py``: the
same scene (:func:`make_scene`, numpy's ``default_rng(seed)`` draws, so
the arrays are the JAX tool's), the same tracker configurations at
``max_tracks=64, max_dets=48``, the same table, scored by the port's
HOTA/CLEAR/Identity metrics. The scene has many objects, crossings,
dropouts, false positives and detector jitter; the numbers are
self-consistent across trackers, for relative comparisons and regression
tracking.

Beside the JAX tool's flags, ``--cpu`` (the CUDA device by default) and
``--lap auction_pallas`` (the auction CUDA kernel on the card, its plain
version on the CPU); the default solver is the exact JV, as the JAX tool
runs it.

Usage: python -m motcpp_tpu_torch.scripts.synthetic_benchmark [--frames 300] [--objects 24] [--lap auction_pallas] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS

TRACKERS = {
    "sort": dict(max_age=3, min_hits=1),
    "bytetrack": dict(),
    "ocsort": dict(min_hits=1),
    "deepocsort": dict(min_hits=1, cmc_off=True),
    "strongsort": dict(),
    "botsort": dict(),
    "boosttrack": dict(with_reid=True),
    "hybridsort": dict(min_hits=1),
    "ucmctrack": dict(),
}
EMB_TRACKERS = {"deepocsort", "strongsort", "botsort", "boosttrack", "hybridsort"}
HEADER = (f"{'tracker':12s}{'HOTA':>8s}{'MOTA':>8s}{'IDF1':>8s}{'DetA':>8s}"
          f"{'AssA':>8s}{'IDSW':>6s}")


def make_scene(T, n_obj, seed=0, img_w=1920, img_h=1080, drop=0.08, fp=0.5):
    rng = np.random.default_rng(seed)
    id_embs = rng.normal(0, 1, (n_obj, 32)).astype(np.float32)
    id_embs /= np.linalg.norm(id_embs, axis=1, keepdims=True)
    cx = rng.uniform(100, img_w - 100, n_obj)
    cy = rng.uniform(100, img_h - 100, n_obj)
    # velocities chosen to create crossings
    vx = rng.uniform(-8, 8, n_obj)
    vy = rng.uniform(-5, 5, n_obj)
    w = rng.uniform(50, 110, n_obj)
    h = rng.uniform(120, 240, n_obj)

    gt, dets, embs = {}, {}, {}
    for t in range(1, T + 1):
        cxs = (cx + vx * t) % (img_w - 200) + 100
        cys = (cy + vy * t) % (img_h - 300) + 100
        boxes = np.stack([cxs - w / 2, cys - h / 2, cxs + w / 2, cys + h / 2], 1)
        gt[t] = (np.arange(1, n_obj + 1), boxes.copy(), np.ones(n_obj))
        rows, erows = [], []
        for i in range(n_obj):
            if rng.random() < drop:
                continue
            b = boxes[i] + rng.normal(0, 2.5, 4)
            conf = rng.uniform(0.6, 0.99)
            if rng.random() < 0.1:  # occasional low-conf (occluded)
                conf = rng.uniform(0.2, 0.45)
            rows.append([*b, conf, 0])
            e = id_embs[i] + rng.normal(0, 0.08, 32).astype(np.float32)
            erows.append(e / np.linalg.norm(e))
        if rng.random() < fp:
            x0 = rng.uniform(0, img_w - 80)
            y0 = rng.uniform(0, img_h - 170)
            rows.append([x0, y0, x0 + 70, y0 + 160, rng.uniform(0.5, 0.8), 0])
            e = rng.normal(0, 1, 32).astype(np.float32)
            erows.append(e / np.linalg.norm(e))
        dets[t] = np.asarray(rows, np.float32).reshape(-1, 6)
        embs[t] = np.asarray(erows, np.float32).reshape(-1, 32)
    return gt, dets, embs


def row_line(name, m):
    """The JAX tool's table row of ``name``'s metrics ``m``."""
    return (f"{name:12s}{m['HOTA']:8.2f}{m['MOTA']:8.2f}{m['IDF1']:8.2f}"
            f"{m['DetA']:8.2f}{m['AssA']:8.2f}{m['IDSW']:6d}"
            f"   ({m['seconds']:.0f}s)")


def run_table(frames=300, objects=24, trackers=None, lap="jv",
              device="cuda", progress=None):
    """{tracker: {"HOTA", "MOTA", "IDF1", "DetA", "AssA", "IDSW",
    "seconds"}} of ``trackers`` (default: every one, in name order) over
    ``frames`` frames of :func:`make_scene` with ``objects`` objects,
    each built at ``max_tracks=64, max_dets=48`` with ``lap_impl=lap`` on
    ``device`` (the CUDA device by default; it raises where there is
    none). ``progress(line)`` gets each row's table line as it is done."""
    import motcpp_tpu_torch
    from motcpp_tpu_torch.metrics import (
        clear_metrics,
        hota_metrics,
        identity_metrics,
    )

    trackers = sorted(TRACKERS) if trackers is None else list(trackers)
    unknown = [t for t in trackers if t not in TRACKERS]
    if unknown:
        raise SystemExit(f"unknown tracker(s) {unknown}; valid: "
                         f"{sorted(TRACKERS)}")
    resolve_device(device)
    gt, dets, embs = make_scene(frames, objects)
    img = np.zeros((1080, 1920, 3), np.uint8)
    table = {}
    for name in trackers:
        kw = dict(TRACKERS[name])
        kw.update(max_tracks=64, max_dets=48, lap_impl=lap)
        tr = motcpp_tpu_torch.create_tracker(name, device=device, **kw)
        pred = {}
        t0 = time.time()
        for t in range(1, frames + 1):
            e = embs[t] if name in EMB_TRACKERS else None
            out = tr.update(dets[t], img, e)
            if out.shape[0]:
                pred[t] = (
                    out[:, 4].astype(int),
                    out[:, :4].astype(float),
                    out[:, 5].astype(float),
                )
        c = clear_metrics(gt, pred)
        i = identity_metrics(gt, pred)
        h = hota_metrics(gt, pred)
        table[name] = {"HOTA": h["HOTA"], "MOTA": c["MOTA"],
                       "IDF1": i["IDF1"], "DetA": h["DetA"],
                       "AssA": h["AssA"], "IDSW": int(c["IDSW"]),
                       "seconds": time.time() - t0}
        if progress is not None:
            progress(row_line(name, table[name]))
    return table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--objects", type=int, default=24)
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--trackers", nargs="*", default=sorted(TRACKERS))
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)

    print(HEADER)
    print("-" * len(HEADER))
    run_table(args.frames, args.objects, args.trackers, args.lap, device,
              progress=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
