#!/usr/bin/env python3
"""Many concurrent streams on one device: the pattern behind the
stream-batched runner.

Counterpart of the JAX package's ``examples/multistream_tpu.py``, whose
name it keeps so the two are easy to pair; here it runs on the H100 (or
the CPU with ``--cpu``). The functional core (init_fn, step_fn) steps
all S streams at once, one call a frame inside
``parallel/streams.py::MultiStreamRunner``, without any per-stream
Python. The scene is the JAX example's: built on the host with numpy
from ``default_rng(0)``, then moved to the device.

Run: python -m motcpp_tpu_torch.examples.multistream_tpu [--cpu] [--streams 64] [--frames 30] [--lap jv]
"""

import argparse
import sys

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )
    from motcpp_tpu_torch.parallel import MultiStreamRunner

    S, T, N = args.streams, args.frames, 8
    cfg = ByteTrackConfig(max_tracks=16, max_dets=N, lap_impl=args.lap)
    init_fn, step_fn = make_bytetrack(cfg, device=device)
    runner = MultiStreamRunner(init_fn, step_fn, n_streams=S, device=device)

    # synthetic constant-velocity scenes, 4 objects per stream
    rng = np.random.default_rng(0)
    dets = np.zeros((T, S, N, 6), np.float32)
    masks = np.zeros((T, S, N), bool)
    cx = rng.uniform(200, 1700, (S, 4)).astype(np.float32)
    cy = rng.uniform(200, 900, (S, 4)).astype(np.float32)
    v = rng.uniform(-5, 5, (S, 4)).astype(np.float32)
    for t in range(T):
        cx = cx + v
        dets[t, :, :4, 0] = cx - 40
        dets[t, :, :4, 1] = cy - 90
        dets[t, :, :4, 2] = cx + 40
        dets[t, :, :4, 3] = cy + 90
        dets[t, :, :4, 4] = 0.9
        masks[t, :, :4] = True

    outs, out_masks = runner.run(torch.from_numpy(dets).to(device),
                                 torch.from_numpy(masks).to(device))
    n_emit = int(out_masks.sum())
    print(
        f"{S} streams x {T} frames on 1 device(s): "
        f"outs {tuple(outs.shape)}, {n_emit} track emissions"
    )
    # per-stream results: outs[t, s] is the (K, 8) track table of
    # stream s at frame t, rows valid where out_masks[t, s]
    last = outs[-1, 0][out_masks[-1, 0]].cpu().numpy()
    print(f"stream 0, final frame ids: {last[:, 4].astype(int).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
