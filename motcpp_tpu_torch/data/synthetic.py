"""Synthetic multi-stream detections for the rollout.

A copy of ``bench.py::synth_stream_dets``: S streams of n_obj jittered
constant-velocity boxes over T frames, each box missing in 5% of frames,
drawn from a NumPy generator so that the JAX package and the port see
the same input.
"""

from __future__ import annotations

import numpy as np


def synth_stream_dets(rng, T, S, N, n_obj=16, img_w=1920, img_h=1080):
    """Returns dets (T, S, N, 6) float32 and masks (T, S, N) bool."""
    n_obj = min(n_obj, N)
    dets = np.zeros((T, S, N, 6), np.float32)
    masks = np.zeros((T, S, N), bool)
    cx = rng.uniform(100, img_w - 100, (S, n_obj)).astype(np.float32)
    cy = rng.uniform(100, img_h - 100, (S, n_obj)).astype(np.float32)
    vx = rng.uniform(-5, 5, (S, n_obj)).astype(np.float32)
    vy = rng.uniform(-3, 3, (S, n_obj)).astype(np.float32)
    w = rng.uniform(40, 120, (S, n_obj)).astype(np.float32)
    h = rng.uniform(80, 240, (S, n_obj)).astype(np.float32)
    for t in range(T):
        cx = cx + vx + rng.normal(0, 1, (S, n_obj)).astype(np.float32)
        cy = cy + vy + rng.normal(0, 0.5, (S, n_obj)).astype(np.float32)
        visible = rng.random((S, n_obj)) > 0.05  # 5% dropout
        conf = rng.uniform(0.5, 1.0, (S, n_obj)).astype(np.float32)
        dets[t, :, :n_obj, 0] = cx - w / 2
        dets[t, :, :n_obj, 1] = cy - h / 2
        dets[t, :, :n_obj, 2] = cx + w / 2
        dets[t, :, :n_obj, 3] = cy + h / 2
        dets[t, :, :n_obj, 4] = conf
        masks[t, :, :n_obj] = visible
    return dets, masks
