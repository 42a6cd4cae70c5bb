#!/usr/bin/env python3
"""Cross-service stream rebalancing: move a camera without losing IDs.

Counterpart of the JAX package's ``examples/stream_rebalance.py``. Two
``TrackingService`` instances stand in for two serving hosts. A camera
tracks on host A for a while, then operations decides to move it to
host B (load rebalancing, host drain, failover). The per-stream
migration API transfers exactly that camera's tracker state:

    snap = host_a.export_stream(cam)      # one slot's state, numpy
    cam_b = host_b.attach()
    host_b.import_stream(cam_b, snap)     # bit-exact continuation

Every other stream on both hosts keeps running untouched; track IDs and
Kalman state survive the move (the example asserts the post-move rows
equal an unmigrated reference run). The snapshot is the tracker's state
type with one slot's numpy arrays as fields; its size is the sum of
theirs.

Run: python -m motcpp_tpu_torch.examples.stream_rebalance [--cpu] [--frames 12] [--move-at 6] [--lap jv]
"""

import argparse
import sys

import numpy as np

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS


def frame(f):
    """Two pedestrians on deterministic trajectories."""
    return np.array(
        [[10 + 2 * f, 10, 50 + 2 * f, 90, 0.9, 0],
         [200, 200 + 3 * f, 260, 320 + 3 * f, 0.85, 0]],
        np.float32,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--move-at", type=int, default=6)
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from motcpp_tpu_torch.serving import TrackingService

    def make_host():
        return TrackingService.from_tracker(
            "bytetrack", n_streams=4, max_dets=8,
            tracker_kw=dict(max_tracks=16, lap_impl=args.lap), device=device,
        )

    host_a, host_b = make_host(), make_host()
    # host B already serves an unrelated camera: it must not notice
    bystander = host_b.attach()

    # reference: the same camera served uninterrupted on one host
    ref_host = make_host()
    ref_cam = ref_host.attach()

    cam = host_a.attach()
    rows_migrated, rows_ref = [], []

    for f in range(args.frames):
        if f == args.move_at:
            snap = host_a.export_stream(cam)
            host_a.detach(cam)
            cam = host_b.attach()
            host_b.import_stream(cam, snap)
            print(f"frame {f}: camera moved host A -> host B "
                  f"({sum(np.asarray(v).nbytes for v in snap)} "
                  f"bytes of state)")
        host = host_a if f < args.move_at else host_b
        host.submit(cam, frame(f))
        if f >= args.move_at:
            host_b.submit(bystander,
                          np.array([[500, 500, 600, 700, 0.9, 0]],
                                   np.float32))
        batch = host.step()
        rows_migrated.append(batch.tracks_for(cam))

        ref_host.submit(ref_cam, frame(f))
        rows_ref.append(ref_host.step().tracks_for(ref_cam))

    for f, (a, b) in enumerate(zip(rows_migrated, rows_ref)):
        np.testing.assert_array_equal(a, b)
    ids = sorted(set(rows_migrated[-1][:, 4].tolist()))
    print(f"{args.frames} frames, move at {args.move_at}: "
          f"{len(rows_migrated[-1])} tracks, ids {ids} — "
          f"bit-exact vs unmigrated run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
