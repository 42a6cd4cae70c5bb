#!/usr/bin/env python3
"""Multi-stream serving example: the scaling axis.

Counterpart of the JAX package's ``examples/multistream_serving.py``.
Tracks S independent video streams as one stream-batched computation:
state is carried between calls, so this is the shape of a production
serving loop (ingest a batch of frames for all streams, run one rollout,
repeat). Each chunk's wall time is read after the device has finished
(``torch.cuda.synchronize()`` on the card); chunk 0 also loads the
auction kernel, built on its first use.

The JAX example runs its jnp auction (``lap_impl="auction"``); the
default here is ``auction_pallas``, the auction CUDA kernel on the card
(the plain auction on the CPU). The JAX example takes no flags; this
one takes ``--cpu`` and ``--lap``.

Run: python -m motcpp_tpu_torch.examples.multistream_serving [--cpu] [--lap auction_pallas]
"""

import argparse
import sys
import time

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--lap", default="auction_pallas", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )
    from motcpp_tpu_torch.parallel import MultiStreamRunner

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    S, T, N, K = 64, 30, 16, 32  # streams, frames/chunk, dets, slots
    print(f"Serving {S} streams on 1 device(s), backend={device.type}")

    cfg = ByteTrackConfig(max_tracks=K, max_dets=N, lap_impl=args.lap)
    init_fn, step_fn = make_bytetrack(cfg, device=device)
    runner = MultiStreamRunner(init_fn, step_fn, n_streams=S, device=device)

    def next_chunk(t0):
        """Stand-in for a real ingest: 8 moving objects per stream."""
        dets = np.zeros((T, S, N, 6), np.float32)
        masks = np.zeros((T, S, N), bool)
        for t in range(T):
            for i in range(8):
                x = (50 * i + 3 * (t0 + t)) % 1800
                dets[t, :, i] = [x, 100 + 40 * i, x + 70, 260 + 40 * i, 0.9, 0]
                masks[t, :, i] = True
        return torch.from_numpy(dets), torch.from_numpy(masks)

    for chunk in range(3):
        dets, masks = next_chunk(chunk * T)
        sync()
        t0 = time.perf_counter()
        outs, out_masks = runner.run(dets.to(device), masks.to(device))
        n = int(out_masks.sum())
        sync()
        dt = time.perf_counter() - t0
        label = "compile+run" if chunk == 0 else "run"
        print(
            f"chunk {chunk}: {label} {dt*1000:7.1f} ms, "
            f"{n} track emissions, "
            f"{S*T/dt:,.0f} aggregate FPS"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
