#!/usr/bin/env python3
"""Moving-camera tracking, end to end on the device.

Counterpart of the JAX package's ``examples/moving_camera.py``. A
panning camera makes stationary-world objects drift in image space;
without camera-motion compensation the Kalman filters chase the pan and
IDs churn. This example runs the full device CMC loop:

  synthetic panning frames (S streams)
    -> motion/cmc.py::sof_jax_batch
                                 one stream-batched Harris+LK pass
                                 estimates every stream's (2, 3) warp
                                 on the device
    -> TrackingService(with_warps=True)
                                 warps ride the native mux alongside
                                 detections; BoT-SORT corner-warps its
                                 predictions inside the batched step

The reference's CMC (ECC / sparse optical flow) is per-frame CPU cv2
(reference: src/motion/cmc/sof.cpp); here S cameras are compensated in
one fixed-shape pass per tick. The service runs on the example's one
device (``device=``), where the JAX example passes ``devices=`` with one
device.

Run: python -m motcpp_tpu_torch.examples.moving_camera [--cpu] [--streams 4] [--ticks 8] [--lap jv]
"""

import argparse
import sys

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS


def textured(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for sc in (4, 8, 16, 32):
        small = rng.random((h // sc + 2, w // sc + 2)).astype(np.float32)
        img += np.kron(small, np.ones((sc, sc), np.float32))[:h, :w]
    return img / img.max() * 255.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from motcpp_tpu_torch.motion.cmc import sof_jax_batch
    from motcpp_tpu_torch.serving import TrackingService

    S, H, W = args.streams, 240, 320
    pans = np.linspace(2, 6, S)  # px/frame, per camera
    base = np.stack([textured(H, W + 64, 100 + s) for s in range(S)])

    svc = TrackingService.from_tracker(
        "botsort", n_streams=S, max_dets=8,
        tracker_kw=dict(max_tracks=16, with_reid=False, lap_impl=args.lap),
        with_warps=True, device=device,
    )
    cams = [svc.attach() for _ in range(S)]

    # two stationary world objects per camera; the pan moves their boxes
    world = np.asarray([[60, 60, 120, 200], [180, 40, 240, 210]], np.float32)

    prev = None
    id_sets = [set() for _ in range(S)]
    for t in range(args.ticks):
        offs = (pans * t).astype(int)
        frames = np.stack([base[s, :, o:o + W] for s, o in enumerate(offs)])
        if prev is not None:
            warps, ok = sof_jax_batch(torch.from_numpy(prev).to(device),
                                      torch.from_numpy(frames).to(device))
            warps = warps.cpu().numpy()
        else:
            warps = np.tile(np.asarray([[1., 0, 0], [0, 1., 0]],
                                       np.float32), (S, 1, 1))
        for s in range(S):
            dets = np.zeros((2, 6), np.float32)
            dets[:, :4] = world
            dets[:, [0, 2]] -= pans[s] * t  # pan shifts boxes left
            dets[:, 4] = 0.9
            svc.submit(cams[s], dets, warp=warps[s])
        batch = svc.step()
        for s in range(S):
            id_sets[s].update(batch.tracks_for(cams[s])[:, 4].astype(int))
        prev = frames
        if t:
            est = [f"{warps[s][0, 2]:+.1f}" for s in range(S)]
            print(f"tick {t}: estimated pans {est} "
                  f"(true {[float(-p) for p in np.round(pans, 1)]})")
    stable = all(len(ids) == 2 for ids in id_sets)
    print(f"IDs per camera: {[sorted(int(i) for i in s) for s in id_sets]}")
    print(f"moving camera ok: {'STABLE' if stable else 'CHURNED'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
