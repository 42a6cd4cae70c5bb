"""Synthetic multi-stream inputs for the rollout.

``synth_stream_dets`` is a copy of ``bench.py::synth_stream_dets``: S
streams of n_obj jittered constant-velocity boxes over T frames, each box
missing in 5% of frames, drawn from a NumPy generator so that the JAX
package and the port see the same input; ``pack_valid_rows`` lays them
out as the serving mux assembles submitted frames. ``pan_frames`` makes
the live camera-motion frames of ``bench.py:269-294`` from a torch
generator, on the generator's device.
"""

from __future__ import annotations

import numpy as np
import torch


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


def pack_valid_rows(dets, masks, *more):
    """Each frame's valid rows moved to the front in their order, as the
    serving mux lays out a submitted frame (its first n rows valid).
    dets (T, S, N, ...), masks (T, S, N) and each of ``more`` (T, S, N,
    ...) are numpy arrays; returns them reordered, then the order
    (T, S, N)."""
    order = np.argsort(~masks, axis=-1, kind="stable")
    out = [np.take_along_axis(a, order.reshape(order.shape
                                               + (1,) * (a.ndim - 3)), 2)
           for a in (dets, masks) + more]
    return (*out, order)


def pan_texture(S, h, w, gen):
    """Per stream a texture of uniform noise upsampled in blocks of 8, 16
    and 32, scaled by /3*255: (S, h, w) float32 on ``gen``'s device."""
    tex = torch.zeros((S, h, w), device=gen.device)
    for blk in (8, 16, 32):
        small = torch.rand((S, h // blk + 1, w // blk + 1), generator=gen,
                           device=gen.device)
        tex += small.repeat_interleave(blk, 1).repeat_interleave(
            blk, 2)[:, :h, :w]
    return tex / 3.0 * 255.0


def pan_frames(T, S, h, w, gen):
    """bench.py's live-CMC frames: each stream's ``pan_texture`` panned
    left by an integer 0-3 px a frame (cur(x) = prev(x + pan)). Returns
    frames (T, S, h, w) float32 and pans (S,) int64, on ``gen``'s
    device."""
    pans = torch.randint(0, 4, (S,), generator=gen, device=gen.device)
    tex = pan_texture(S, h, w + int(pans.max()) * T, gen)
    frames = torch.empty((T, S, h, w), device=gen.device)
    cols = torch.arange(w, device=gen.device)
    for t in range(T):
        idx = pans[:, None] * t + cols
        frames[t] = tex.gather(2, idx[:, None, :].expand(S, h, w))
    return frames, pans
