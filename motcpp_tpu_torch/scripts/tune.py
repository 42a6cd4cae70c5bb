#!/usr/bin/env python3
"""Random-search hyperparameter tuning over a tracker's YAML search space.

Counterpart of the JAX package's ``scripts/tune.py``: the per-tracker
YAMLs (configs/trackers/*.yaml) carry Ray-Tune-style search nodes
(``type: uniform|randint|choice`` with ``range``/``choices``), read here
by the port's reader (no PyYAML); the tool samples N parameter sets
(``TrackerConfig.sample``, the JAX draws), runs each over the bundled
MOT17-mini (the scored no-ablation window), scores it with the port's
HOTA/CLEAR/Identity metrics and prints the same lines as the JAX tool.

Beside the JAX tool's flags, ``--cpu`` (the CUDA device by default) and
``--lap`` (the exact JV by default, as the JAX tool runs it;
``auction_pallas`` is the auction CUDA kernel on the card, its plain
version on the CPU).

Usage:
    python -m motcpp_tpu_torch.scripts.tune <tracker> [--trials 20] [--metric HOTA]
        [--seed 0] [--mot-root assets/MOT17-mini/train] [--frames 8] [--cpu] [--lap jv]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS

ROOT = Path(__file__).resolve().parent.parent.parent


def evaluate_params(tracker_name, params, mot_root, frames, work_dir,
                    device="cuda", lap_impl="jv"):
    """Run one parameter set over the dataset on ``device`` with
    ``lap_impl``; each sequence's rows go to ``<work_dir>/<seq>.txt``.
    Returns the combined metrics ({} where nothing was scored)."""
    import motcpp_tpu_torch
    from motcpp_tpu_torch.data import (
        MOT17Dataset,
        convert_to_mot_format,
        write_mot_results,
    )
    from motcpp_tpu_torch.metrics import combine_metrics, evaluate_sequence

    resolve_device(device)
    ds = MOT17Dataset(mot_root)
    rows = []
    for seq in ds.sequences:
        detections = ds.load_detections(seq.det_path)
        tracker = motcpp_tpu_torch.create_tracker(
            tracker_name, max_dets=128, max_tracks=128, device=device,
            lap_impl=lap_impl, **params
        )
        out_file = Path(work_dir) / f"{seq.name}.txt"
        if out_file.exists():
            out_file.unlink()
        dummy = np.zeros((1080, 1920, 3), np.uint8)
        for frame_id in sorted(detections)[:frames]:
            dets = detections.get(frame_id, np.zeros((0, 6), np.float32))
            tracks = tracker.update(dets, dummy)
            if tracks.shape[0]:
                write_mot_results(
                    out_file, convert_to_mot_format(tracks, frame_id)
                )
        gt = Path(mot_root) / seq.name / "gt" / "gt.txt"
        if gt.exists() and out_file.exists():
            rows.append(evaluate_sequence(gt, out_file))
    return combine_metrics(rows) if rows else {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tracker")
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--metric", default="HOTA",
                    choices=["HOTA", "MOTA", "IDF1"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mot-root",
                    default=str(ROOT / "assets" / "MOT17-mini" / "train"))
    ap.add_argument("--frames", type=int, default=8,
                    help="frames per sequence (the bundled GT spans 8)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--lap", default="jv", choices=IMPLS,
                    help="the trackers' assignment solver")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)

    from motcpp_tpu_torch.config import load_tracker_config

    cfg = load_tracker_config(args.tracker)
    if not cfg.search_space:
        print(f"{args.tracker}.yaml defines no search nodes — nothing to tune")
        return 1
    rng = np.random.default_rng(args.seed)

    results = []
    with tempfile.TemporaryDirectory() as work:
        # trial 0 = the YAML defaults (the baseline every sample must beat)
        trials = [cfg.as_kwargs()] + [
            cfg.sample(rng) for _ in range(args.trials - 1)
        ]
        for i, params in enumerate(trials):
            m = evaluate_params(
                args.tracker, params, args.mot_root, args.frames, work,
                device, args.lap
            )
            score = m.get(args.metric, float("nan"))
            results.append((score, params, m))
            tag = "default" if i == 0 else f"trial {i}"
            print(f"# {tag:10s} {args.metric}={score:6.2f}  {params}")

    results.sort(key=lambda r: -(r[0] if r[0] == r[0] else -1e9))
    best_score, best_params, best_m = results[0]
    print("\n== best ==")
    print(f"{args.metric} {best_score:.2f} | MOTA {best_m.get('MOTA', 0):.2f} "
          f"| IDF1 {best_m.get('IDF1', 0):.2f}")
    print(best_params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
