"""Evaluation CLI of the port: run a tracker over MOT sequences and write
MOT-Challenge result files.

Usage (mirrors ``motcpp_tpu/cli.py`` and the reference's
tools/motcpp_eval.cpp:19-38):

    python -m motcpp_tpu_torch.cli <mot_root> <output_dir> [tracker]
                                   [det_emb_root] [model] [--cpu] ...

Runs on the CUDA device unless ``--cpu`` is given. Per sequence: load
detections, run the tracker frame by frame, append MOT-Challenge rows.
Replicates the reference's ablation-split handling
(tools/motcpp_eval.cpp:336-375): when detection frames extend past 1.5x
the GT range, only frames after ``max_det - max_gt`` are processed and
output frame ids are shifted down by that offset.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from motcpp_tpu_torch.data import (
    MOT17Dataset,
    convert_to_mot_format,
    read_gt_max_frame,
    write_mot_results,
)


def build_tracker(name: str, fps: int = 30, device="cuda", **overrides):
    """Construct a tracker with the eval tool's defaults (reference:
    tools/motcpp_eval.cpp:96-316); capacities and the assignment solver
    can be overridden."""
    import motcpp_tpu_torch

    defaults: dict = {}
    if name.lower() == "bytetrack":
        defaults = dict(frame_rate=fps)
    defaults.update(overrides)
    return motcpp_tpu_torch.create_tracker(name, device=device, **defaults)


def run_sequence(tracker, seq_info, detections: dict, output_file: Path,
                 no_ablation: bool = False, limit_frames: int = 0) -> int:
    """Track one sequence, appending MOT rows; returns frames processed.

    no_ablation: process every detection frame from frame 1 instead of
    the reference's ablation window. limit_frames: if > 0, stop after
    this many frames.
    """
    if output_file.exists():
        output_file.unlink()

    frames = sorted(detections)
    frame_offset = 0
    if frames and not no_ablation:
        max_gt = read_gt_max_frame(seq_info.gt_path)
        max_det = frames[-1]
        if max_gt > 0 and max_det > max_gt * 1.5:
            frame_offset = max_det - max_gt
            frames = [f for f in frames if f > frame_offset]
            print(
                f"  Detected ablation offset: {frame_offset} "
                f"(processing {len(frames)} frames)"
            )
    if limit_frames > 0:
        frames = frames[:limit_frames]

    # the reference eval's dummy 1080p frame when images are not loaded
    dummy = np.zeros((1080, 1920, 3), np.uint8)
    for frame_id in frames:
        tracks = tracker.update(detections[frame_id], dummy)
        if tracks.shape[0] > 0:
            write_mot_results(
                output_file,
                convert_to_mot_format(tracks, frame_id - frame_offset),
            )
    return len(frames)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="motcpp_tpu_torch.cli",
        description="Run a tracker over MOT sequences and write "
        "MOT-Challenge result files.",
    )
    ap.add_argument("mot_root")
    ap.add_argument("output_dir")
    ap.add_argument("tracker", nargs="?", default="bytetrack")
    ap.add_argument("det_emb_root", nargs="?", default="")
    ap.add_argument("model", nargs="?", default="")
    ap.add_argument("--max-dets", type=int, default=128)
    ap.add_argument("--max-tracks", type=int, default=256)
    ap.add_argument("--lap", default="jv",
                    choices=["jv", "auction", "auction_pallas"],
                    help="assignment solver (auction_pallas = the CUDA "
                    "auction kernel on the card, its plain version on "
                    "the CPU)")
    ap.add_argument(
        "--no-ablation", action="store_true",
        help="process every detection frame from frame 1 instead of the "
        "reference's ablation window (long-horizon regression runs)",
    )
    ap.add_argument(
        "--limit-frames", type=int, default=0,
        help="stop each sequence after N frames (0 = all)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    dataset = MOT17Dataset(args.mot_root, args.det_emb_root, args.model)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    for seq in dataset.sequences:
        print(f"Processing {seq.name} ({seq.fps} fps)")
        t0 = time.time()
        detections = dataset.load_detections(seq.det_path)
        tracker = build_tracker(
            args.tracker,
            fps=seq.fps,
            device=device,
            max_dets=args.max_dets,
            max_tracks=args.max_tracks,
            lap_impl=args.lap,
        )
        out_file = out_dir / f"{seq.name}.txt"
        n = run_sequence(tracker, seq, detections, out_file,
                         no_ablation=args.no_ablation,
                         limit_frames=args.limit_frames)
        print(f"  {n} frames in {time.time() - t0:.1f}s -> {out_file}")

    print("Evaluation completed!")
    print(f"Results saved to: {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
