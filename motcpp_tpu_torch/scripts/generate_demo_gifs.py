#!/usr/bin/env python3
"""Render tracker demo GIFs: single-tracker per sequence, multi-tracker
comparison grids, and a synthetic moving-camera demo.

Counterpart of the JAX package's ``scripts/generate_demo_gifs.py``:
colored boxes with id+confidence labels, fading trajectory trails, a
header banner with tracker name and frame counter, and a labeled
side-by-side grid when several trackers are requested
(``utils/visualization.py``). The tracking (:func:`track_frames`) runs
on the CUDA device unless given ``--cpu``; the drawing and the GIF
encoding are host work and need cv2 or PIL, as in the JAX package.

Usage:
    python -m motcpp_tpu_torch.scripts.generate_demo_gifs <mot_root> <out_dir>
        [tracker[,tracker2,...]] [--synthetic] [--fps N] [--frames N] [--cpu]

With more than one tracker, one comparison-grid GIF per sequence is
written in addition to the per-tracker GIFs. --synthetic ignores
mot_root and renders the deterministic camera-pan scene
(``data/synthetic.py::camera_pan_scene``) instead, useful when a dataset
ships only a handful of frames.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from motcpp_tpu_torch.device import resolve_device


def track_frames(tracker_name, frame_iter, device="cuda"):
    """Run ``tracker_name`` (its defaults) on ``device`` over
    ``frame_iter``'s (frame_id, img, dets); returns each frame's
    (frame_id, img, tracks), tracks the (M, 8) rows of ``update()``."""
    import motcpp_tpu_torch

    resolve_device(device)
    tracker = motcpp_tpu_torch.create_tracker(tracker_name, device=device)
    return [(frame_id, img, tracker.update(dets, img))
            for frame_id, img, dets in frame_iter]


def draw_frames(tracker_name, tracked):
    """``track_frames``' result drawn as the JAX tool draws it: boxes,
    confidences, trails and the header, one BGR image a frame."""
    from motcpp_tpu_torch.utils.visualization import plot_results

    history: dict = {}
    return [plot_results(np.asarray(img), tracks, show_trajectories=True,
                         history=history, show_conf=True,
                         header=f"{tracker_name}  frame {frame_id}")
            for frame_id, img, tracks in tracked]


def _dataset_frames(seq, dets_map):
    from motcpp_tpu_torch.data.mot17 import imread

    for frame_id, img_path in zip(seq.frame_ids, seq.frame_paths):
        img = imread(img_path)
        if img is None:
            continue
        yield frame_id, img, dets_map.get(
            frame_id, np.zeros((0, 6), np.float32)
        )


def synthetic_frames(n_frames=40):
    from motcpp_tpu_torch.data.synthetic import camera_pan_scene

    frames, dets_all, _ = camera_pan_scene(
        n_frames=n_frames, img_hw=(240, 320),
        dropout_frames={2: set(range(15, 20))},
    )
    for t, (img, dets) in enumerate(zip(frames, dets_all)):
        yield t + 1, img, dets


def main(argv=None):
    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("mot_root")
    ap.add_argument("out_dir")
    ap.add_argument("trackers", nargs="?", default="bytetrack",
                    help="comma-separated tracker names")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--frames", type=int, default=40,
                    help="synthetic scene length")
    ap.add_argument("--cpu", action="store_true",
                    help="track on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    trackers = [t.strip() for t in args.trackers.split(",") if t.strip()]

    from motcpp_tpu_torch.utils.visualization import make_grid, save_gif

    def render_sequence(seq_name, make_iter):
        per_tracker = {}
        for trk in trackers:
            frames = draw_frames(trk, track_frames(trk, make_iter(), device))
            if not frames:
                continue
            per_tracker[trk] = frames
            gif = out_dir / f"{seq_name}_{trk}.gif"
            save_gif(frames, gif, fps=args.fps)
            print(f"wrote {gif} ({len(frames)} frames)")
        if len(per_tracker) > 1:
            n = min(len(f) for f in per_tracker.values())
            grid = [
                make_grid({t: per_tracker[t][i] for t in per_tracker})
                for i in range(n)
            ]
            gif = out_dir / f"{seq_name}_comparison.gif"
            save_gif(grid, gif, fps=args.fps)
            print(f"wrote {gif} (grid of {len(per_tracker)})")

    if args.synthetic:
        render_sequence(
            "synthetic_pan", lambda: synthetic_frames(args.frames)
        )
        return 0

    from motcpp_tpu_torch.data import MOT17Dataset

    ds = MOT17Dataset(args.mot_root)
    for seq in ds.sequences:
        dets_map = ds.load_detections(seq.det_path)
        render_sequence(seq.name, lambda: _dataset_frames(seq, dets_map))
    return 0


if __name__ == "__main__":
    sys.exit(main())
