#!/usr/bin/env python3
"""Using a tracker's functional core directly: for embedding a tracker
inside your own PyTorch program (e.g. after a detector on the same
device, so boxes never leave it).

Counterpart of the JAX package's ``examples/functional_core.py``. The
port's ``make_ocsort(cfg, device)`` gives ``init_fn(n_streams)`` and a
stream-batched ``step_fn(state, dets (S, N, 6), mask (S, N))``; this
example runs it at S=1. Where the JAX example scans ``step_fn`` over a
clip with ``jax.lax.scan``, this one calls it in a Python loop over the
clip's frames, stacks the outputs and drops the stream axis.

Run: python -m motcpp_tpu_torch.examples.functional_core [--cpu] [--lap jv]
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
    ap.add_argument("--lap", default="jv", choices=IMPLS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from motcpp_tpu_torch.models.ocsort import OCSortConfig, make_ocsort

    cfg = OCSortConfig(min_hits=1, max_tracks=16, max_dets=8,
                       lap_impl=args.lap)
    init_fn, step_fn = make_ocsort(cfg, device=device)

    # pad detections to the static capacity N=8, mask the real rows, and
    # add the stream axis (S=1)
    def pad(rows):
        d = np.zeros((1, 8, 6), np.float32)
        m = np.zeros((1, 8), bool)
        d[0, : len(rows)] = rows
        m[0, : len(rows)] = True
        return torch.from_numpy(d).to(device), torch.from_numpy(m).to(device)

    state = init_fn(1)
    for frame in range(1, 6):
        dets, mask = pad(
            [
                [100 + 5 * frame, 100, 200 + 5 * frame, 300, 0.9, 0],
                [500, 400 + 3 * frame, 620, 640 + 3 * frame, 0.8, 0],
            ]
        )
        state, (out, out_mask) = step_fn(state, dets, mask)
        rows = out[0][out_mask[0]].cpu().numpy()
        print(f"frame {frame}: ids={rows[:, 4].astype(int).tolist()}")

    # the same step_fn over a whole clip, one call a frame
    T = 20
    clip = [pad([[100 + 5 * t, 100, 200 + 5 * t, 300, 0.9, 0]])[0]
            for t in range(T)]
    clip_mask = pad([[0, 0, 1, 1, 0.9, 0]])[1]
    state, outs, out_masks = init_fn(1), [], []
    for dets in clip:
        state, (out, out_mask) = step_fn(state, dets, clip_mask)
        outs.append(out[0])
        out_masks.append(out_mask[0])
    outs, out_masks = torch.stack(outs), torch.stack(out_masks)
    print(f"scanned clip: outs {tuple(outs.shape)}, "
          f"emissions {int(out_masks.sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
