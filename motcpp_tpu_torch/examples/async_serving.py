#!/usr/bin/env python3
"""Asynchronous serving example: the native ingest runtime.

Counterpart of the JAX package's ``examples/async_serving.py``.
``multistream_serving`` shows the synchronous shape (one pre-batched
rollout per chunk). Real deployments have independent cameras pushing
frames from their own threads at their own cadence. This example runs
the full serving stack:

  camera threads -> native C++ stream mux -> fixed-shape batch
                 -> one stream-batched tracker step per tick
                 -> per-stream rows

Streams attach and detach while the service runs; a stream that missed
a tick is frozen (masked state select), so its tracking is bit-exact vs
an uninterrupted run. The service runs on the example's one device
(``device=``), where the JAX example spreads the streams over as many
devices as divide them. Which frames reach a tick depends on the
threads' timing, so the counts vary from run to run.

Run: python -m motcpp_tpu_torch.examples.async_serving [--cpu] [--streams 8] [--ticks 12] [--lap jv]
"""

import argparse
import sys
import threading
import time

import numpy as np

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.ops.lap import IMPLS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from motcpp_tpu_torch.serving import TrackingService, native_available

    S = args.streams
    svc = TrackingService.from_tracker(
        "bytetrack", n_streams=S, max_dets=16,
        tracker_kw=dict(max_tracks=32, lap_impl=args.lap), device=device,
    )
    print(f"{S} streams over 1 device(s)")
    print(f"mux backend: {'native C++' if native_available() else 'python'}")

    # --- camera threads: each feeds ~2/3 of the ticks (irregular) --------
    handles = [svc.attach() for _ in range(S)]
    stop = threading.Event()

    def camera(s):
        rng = np.random.default_rng(s)
        t = 0
        while not stop.is_set():
            if rng.random() < 0.67:
                n = int(rng.integers(2, 6))
                x = (rng.uniform(0, 1500, n) + 4 * t).astype(np.float32)
                y = rng.uniform(0, 800, n).astype(np.float32)
                dets = np.stack(
                    [x, y, x + 80, y + 180, rng.uniform(0.6, 1.0, n),
                     np.zeros(n)], axis=1,
                ).astype(np.float32)
                try:
                    svc.submit(handles[s], dets)
                except ValueError:
                    pass  # handle went stale during a live re-attach
            t += 1
            time.sleep(0.002)

    threads = [threading.Thread(target=camera, args=(s,), daemon=True)
               for s in range(S)]
    for th in threads:
        th.start()

    # --- service loop ----------------------------------------------------
    total_rows = 0
    try:
        for tick in range(args.ticks):
            batch = svc.step()  # one stream-batched device step for all S
            rows = int(batch.out_masks.sum())
            total_rows += rows
            print(f"tick {tick:2d}: {int(batch.present.sum())}/{S} streams "
                  f"present, {rows} track rows")
            if tick == args.ticks // 2:  # live detach + re-attach
                svc.detach(handles[0])
                handles[0] = svc.attach()
    finally:
        stop.set()
        for th in threads:
            th.join()

    print(f"served {total_rows} track rows; stats: {svc.stats()}")
    print("async serving ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
