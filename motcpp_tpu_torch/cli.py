"""Evaluation CLI of the port: run a tracker over MOT sequences and write
MOT-Challenge result files.

Usage (mirrors ``motcpp_tpu/cli.py`` and the reference's
tools/motcpp_eval.cpp:19-38):

    python -m motcpp_tpu_torch.cli <mot_root> <output_dir> [tracker]
                                   [det_emb_root] [model] [reid]
                                   [reid_weights] [--cpu] ...

Runs on the CUDA device unless ``--cpu`` is given. Per sequence: load
detections (and pre-generated embeddings, when present), run the tracker
frame by frame, append MOT-Challenge rows. ``reid_weights`` turns on live
ReID from the frames for the appearance trackers when no embeddings are
given; ``--images`` loads the real frames (default: the reference eval's
dummy 1080p frame).
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
from motcpp_tpu_torch.data.mot17 import imread

#: the trackers that take ReID weights (JAX cli.py:25-26)
REID_TRACKERS = ("deepocsort", "strongsort", "botsort", "boosttrack",
                 "hybridsort")


def build_tracker(name: str, fps: int = 30, reid_weights: str = "",
                  device="cuda", **overrides):
    """Construct a tracker with the eval tool's defaults (reference:
    tools/motcpp_eval.cpp:96-316); capacities and the assignment solver
    can be overridden. reid_weights (the reference's 7th CLI argument,
    motcpp_eval.cpp:38,168-282) turns on live ReID for the appearance
    trackers when no pre-generated embeddings are given."""
    import motcpp_tpu_torch

    name = name.lower()
    defaults: dict = {}
    if name == "bytetrack":
        defaults = dict(frame_rate=fps)
    elif name in ("ucmc", "ucmctrack"):
        # dt = 1 / sequence fps (reference: motcpp_eval.cpp:129)
        defaults = dict(dt=1.0 / fps)
    if reid_weights and name in REID_TRACKERS:
        defaults["reid_weights"] = reid_weights
        if name in ("botsort", "hybridsort"):
            defaults["with_reid"] = True
    defaults.update(overrides)
    return motcpp_tpu_torch.create_tracker(name, device=device, **defaults)


def run_sequence(tracker, seq_info, detections: dict, output_file: Path,
                 embeddings: dict | None = None, use_images: bool = False,
                 no_ablation: bool = False, limit_frames: int = 0) -> int:
    """Track one sequence, appending MOT rows; returns frames processed.

    embeddings: frame -> (n, E) pre-generated embeddings (used where the
    row count matches the frame's detections). use_images: load the real
    frame where there is one. no_ablation: process every detection frame
    from frame 1 instead of the reference's ablation window.
    limit_frames: if > 0, stop after this many frames.
    """
    embeddings = embeddings or {}
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
    # (tools/motcpp_eval.cpp:380-447)
    dummy = np.zeros((1080, 1920, 3), np.uint8)
    for frame_id in frames:
        dets = detections[frame_id]
        embs = embeddings.get(frame_id)
        if embs is not None and embs.shape[0] != dets.shape[0]:
            embs = None
        img = dummy
        if use_images and frame_id in seq_info.frame_ids:
            loaded = imread(
                seq_info.frame_paths[seq_info.frame_ids.index(frame_id)])
            if loaded is not None:
                img = loaded
        tracks = tracker.update(dets, img, embs)
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
    ap.add_argument("reid", nargs="?", default="",
                    help="embedding model folder under det_emb_root/embs")
    ap.add_argument(
        "reid_weights", nargs="?", default="",
        help="ReID checkpoint (.pt/.pth/.npz) for live embeddings from the "
        "frames (the reference eval's 7th argument); pre-generated "
        "embedding files still take precedence when present",
    )
    ap.add_argument("--max-dets", type=int, default=128)
    ap.add_argument("--max-tracks", type=int, default=256)
    ap.add_argument("--lap", default="jv",
                    choices=["jv", "auction", "auction_pallas"],
                    help="assignment solver (auction_pallas = the CUDA "
                    "auction kernel on the card, its plain version on "
                    "the CPU)")
    ap.add_argument(
        "--images", action="store_true",
        help="load real frames (default: dummy 1080p images, like the "
        "reference eval when frames are missing)",
    )
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

    dataset = MOT17Dataset(args.mot_root, args.det_emb_root, args.model,
                           args.reid)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    for seq in dataset.sequences:
        print(f"Processing {seq.name} ({seq.fps} fps)")
        t0 = time.time()
        detections = dataset.load_detections(seq.det_path)
        embeddings = dataset.load_embeddings(dataset.emb_path_for(seq.name),
                                             detections)
        tracker = build_tracker(
            args.tracker,
            fps=seq.fps,
            reid_weights=args.reid_weights,
            device=device,
            max_dets=args.max_dets,
            max_tracks=args.max_tracks,
            lap_impl=args.lap,
        )
        out_file = out_dir / f"{seq.name}.txt"
        n = run_sequence(tracker, seq, detections, out_file, embeddings,
                         use_images=args.images,
                         no_ablation=args.no_ablation,
                         limit_frames=args.limit_frames)
        print(f"  {n} frames in {time.time() - t0:.1f}s -> {out_file}")

    print("Evaluation completed!")
    print(f"Results saved to: {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
