#!/usr/bin/env python3
"""Minimal single-stream tracking loop: the reference's README
quick-start (reference: README.md "Quick Start",
include/motcpp/motcpp.hpp umbrella usage) on the port.

Counterpart of the JAX package's ``examples/basic_tracking.py``. An
unknown ``--tracker`` raises ValueError ("Unknown tracker ...", with the
list of trackers).

Run: python -m motcpp_tpu_torch.examples.basic_tracking [--cpu] [--tracker bytetrack] [--lap jv]
"""

import argparse
import sys

import numpy as np

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--tracker", default="bytetrack")
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    import motcpp_tpu_torch

    tracker = motcpp_tpu_torch.create_tracker(
        args.tracker, max_tracks=32, max_dets=16, device=device,
        lap_impl=args.lap,
    )
    img = np.zeros((1080, 1920, 3), np.uint8)  # frame (dims + CMC + crops)

    # two objects moving right; a third appears at frame 5
    for frame in range(1, 11):
        dets = [
            [100 + 6 * frame, 200, 180 + 6 * frame, 420, 0.92, 0],
            [600 + 4 * frame, 300, 700 + 4 * frame, 560, 0.88, 0],
        ]
        if frame >= 5:
            dets.append([1200, 400, 1300, 660, 0.75, 0])
        tracks = tracker.update(np.asarray(dets, np.float32), img)
        ids = tracks[:, 4].astype(int).tolist()
        print(f"frame {frame:2d}: {tracks.shape[0]} tracks, ids={ids}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
