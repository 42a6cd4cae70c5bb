#!/usr/bin/env python3
"""Simple tracking example: the hello-world of the framework.

Counterpart of the JAX package's ``examples/simple_tracking.py`` (itself
the reference's examples/simple_tracking.cpp): construct a ByteTrack
tracker, feed a few frames of synthetic detections of two moving
objects, print the tracks. It prints the JAX example's lines, its title
included.

Run: python -m motcpp_tpu_torch.examples.simple_tracking [--cpu] [--lap jv]
"""

import argparse
import sys

import numpy as np

import motcpp_tpu_torch
from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    print("motcpp_tpu — Simple Tracking Example")
    print("====================================\n")

    tracker = motcpp_tpu_torch.create_tracker(
        "bytetrack", track_thresh=0.5, max_tracks=32, max_dets=16,
        device=device, lap_impl=args.lap,
    )
    img = np.zeros((480, 640, 3), np.uint8)

    for frame in range(1, 6):
        dets = np.array(
            [
                # [x1, y1, x2, y2, conf, cls]
                [100 + 10 * frame, 100, 160 + 10 * frame, 260, 0.9, 0],
                [400, 50 + 8 * frame, 470, 220 + 8 * frame, 0.85, 0],
            ],
            np.float32,
        )
        tracks = tracker.update(dets, img)
        print(f"Frame {frame}: {len(tracks)} tracks")
        for t in tracks:
            print(
                f"  id={int(t[4]):2d} box=({t[0]:5.1f},{t[1]:5.1f},"
                f"{t[2]:5.1f},{t[3]:5.1f}) conf={t[5]:.2f}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
