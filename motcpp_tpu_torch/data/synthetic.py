"""Synthetic multi-stream inputs for the rollout.

``synth_stream_dets`` is a copy of ``bench.py::synth_stream_dets``: S
streams of n_obj jittered constant-velocity boxes over T frames, each box
missing in 5% of frames, drawn from a NumPy generator so that the JAX
package and the port see the same input; ``obb_stream_dets`` turns them
into rotating oriented boxes; ``pack_valid_rows`` lays them out as the
serving mux assembles submitted frames. ``pan_frames`` makes
the live camera-motion frames of ``bench.py:269-294`` from a torch
generator, on the generator's device. ``camera_pan_scene`` and
``ablation_scene`` are copies of ``motcpp_tpu/data/synthetic.py``'s
deterministic scenes (NumPy only): a pan over a fixed texture with
per-identity embeddings, and the ablation-scale benchmark scene with
ground truth and camera warps.
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


def obb_stream_dets(rng, T, S, N, n_obj=16):
    """:func:`synth_stream_dets` as oriented boxes: dets (T, S, N, 7)
    [cx, cy, w, h, angle, conf, cls] and masks (T, S, N). Each object's
    angle starts uniform in [-pi/4, pi/4], drawn from a generator seeded
    0, and turns 0.01 rad a frame."""
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    n_obj = min(n_obj, N)
    ang0 = np.random.default_rng(0).uniform(-np.pi / 4, np.pi / 4,
                                            (S, n_obj))
    ang = (ang0[None] + 0.01 * np.arange(T)[:, None, None]).astype(np.float32)
    out = np.zeros((T, S, N, 7), np.float32)
    out[..., 0:2] = (dets[..., 0:2] + dets[..., 2:4]) * 0.5
    out[..., 2:4] = dets[..., 2:4] - dets[..., 0:2]
    out[..., :n_obj, 4] = ang
    out[..., 5:7] = dets[..., 4:6]
    return out, masks


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


def camera_pan_scene(
    n_frames: int = 30,
    img_hw: tuple = (240, 320),
    pan_per_frame: tuple = (3, 1),
    n_objects: int = 5,
    emb_dim: int = 32,
    dropout_frames: dict | None = None,
    seed: int = 0,
):
    """Build a deterministic pan sequence.

    The camera slides over a fixed smooth texture by ``pan_per_frame``
    (dx, dy) pixels per frame; objects are STATIC in world coordinates,
    so their image-space boxes translate opposite to the pan — exactly
    the motion a CMC warp must compensate before association.

    Returns (frames, dets_per_frame, embs_per_frame):
      frames: list of (H, W, 3) uint8 BGR images
      dets_per_frame: list of (n, 6) float32 [x1,y1,x2,y2,conf,cls]
      embs_per_frame: list of (n, emb_dim) float32 unit vectors —
        one fixed vector per object identity (plus tiny deterministic
        per-frame noise), so embedding-driven association is exercised.

    dropout_frames: {object_index: set(frame_ids)} detections to drop
    (forces re-matching through the lost/OCR/gallery paths).
    """
    H, W = img_hw
    dx, dy = pan_per_frame
    rng = np.random.default_rng(seed)
    dropout_frames = dropout_frames or {}

    # world texture big enough for the full pan, smooth enough for LK/ECC
    world_h = H + abs(dy) * n_frames + 64
    world_w = W + abs(dx) * n_frames + 64
    coarse = rng.uniform(0, 255, (world_h // 8 + 2, world_w // 8 + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, world_h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, world_w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    tex = (
        coarse[y0][:, x0] * (1 - wy) * (1 - wx)
        + coarse[y0][:, x0 + 1] * (1 - wy) * wx
        + coarse[y0 + 1][:, x0] * wy * (1 - wx)
        + coarse[y0 + 1][:, x0 + 1] * wy * wx
    )
    # speckle so corner detectors have features
    tex = tex + rng.normal(0, 12, tex.shape)
    tex = np.clip(tex, 0, 255).astype(np.uint8)

    # objects: static world boxes spread over the visible strip
    obj_w = rng.uniform(24, 40, n_objects)
    obj_h = rng.uniform(48, 80, n_objects)
    obj_cx = rng.uniform(60, W - 60, n_objects) + np.arange(n_objects) * dx * 2
    obj_cy = rng.uniform(60, H - 60, n_objects)
    obj_shade = rng.uniform(60, 200, n_objects)
    embs_base = rng.normal(0, 1, (n_objects, emb_dim)).astype(np.float32)
    embs_base /= np.linalg.norm(embs_base, axis=1, keepdims=True)

    frames, dets_all, embs_all = [], [], []
    for t in range(n_frames):
        ox = 32 + max(dx, 0) * t - min(dx, 0) * (n_frames - t)
        oy = 32 + max(dy, 0) * t - min(dy, 0) * (n_frames - t)
        frame = tex[oy:oy + H, ox:ox + W].copy()
        dets, embs = [], []
        for k in range(n_objects):
            # world -> image coords under the pan
            x1 = obj_cx[k] - obj_w[k] / 2 - ox + 32
            y1 = obj_cy[k] - obj_h[k] / 2 - oy + 32
            x2 = x1 + obj_w[k]
            y2 = y1 + obj_h[k]
            # paint the object (visible texture for the detectors)
            xi1, yi1 = int(max(x1, 0)), int(max(y1, 0))
            xi2, yi2 = int(min(x2, W)), int(min(y2, H))
            if xi2 > xi1 and yi2 > yi1:
                frame[yi1:yi2, xi1:xi2] = (
                    0.5 * frame[yi1:yi2, xi1:xi2] + 0.5 * obj_shade[k]
                ).astype(np.uint8)
            in_view = 0 <= x1 and x2 < W and 0 <= y1 and y2 < H
            dropped = t in dropout_frames.get(k, ())
            if in_view and not dropped:
                # deterministic per-frame detection jitter + conf
                jx = 0.5 * np.sin(0.7 * t + k)
                jy = 0.5 * np.cos(0.9 * t + 2 * k)
                conf = 0.75 + 0.2 * ((k + t) % 4) / 4.0
                dets.append([x1 + jx, y1 + jy, x2 + jx, y2 + jy, conf, 0.0])
                e = embs_base[k] + 0.02 * np.sin(
                    np.arange(emb_dim, dtype=np.float32) + t + k
                )
                embs.append(e / np.linalg.norm(e))
        frames.append(np.repeat(frame[:, :, None], 3, axis=2))
        dets_all.append(np.asarray(dets, np.float32).reshape(len(dets), 6))
        embs_all.append(
            np.asarray(embs, np.float32).reshape(len(embs), emb_dim)
        )
    return frames, dets_all, embs_all


def ablation_scene(
    n_frames: int = 600,
    img_wh: tuple = (1920, 1080),
    concurrency: tuple = (38, 85),
    emb_dim: int = 64,
    seed: int = 0,
    pan_amp: tuple = (40.0, 12.0),
    pan_period: float = 300.0,
):
    """Ablation-scale tracking benchmark scene (no images, 600+ frames).

    A reproducible stand-in for the MOT17 ablation split (which ships
    via a GitHub release the reference downloads in
    scripts/auto_benchmark.sh — unavailable without egress): identity
    churn via edge entry/exit, 30-80 concurrent pedestrians, pairwise
    occlusions with visibility-driven detection degradation, smooth
    sinusoidal camera pan (returned as per-frame GT warps for
    precomputed-warp injection), and detection noise calibrated to the
    vendored FRCNN det files (w 66-75 +/- 15-60 px, h 180-193 px, ~90%
    of confidences >= 0.81 with an ~8% low-conf tail, ~0.7 false
    positives per frame; measured from assets/MOT17-mini det.txt).

    Returns (gt, dets, embs, warps), all dicts keyed by frame 1..T:
      gt[t]   = (ids (G,), boxes (G,4) xyxy, vis (G,))  — GT rows only
                for objects with visibility >= 0.25 (TrackEval-style
                occluded-GT handling).
      dets[t] = (n, 6) [x1,y1,x2,y2,conf,cls]
      embs[t] = (n, emb_dim) unit vectors, identity-stable, corrupted
                in proportion to occlusion.
      warps[t] = (2, 3) affine mapping frame t-1 image coords -> frame
                t image coords (identity at t=1) — what a perfect CMC
                estimator would return.
    """
    W, H = img_wh
    lo, hi = concurrency
    rng = np.random.default_rng(seed)

    # camera path: smooth two-frequency pan (never exactly periodic)
    t_axis = np.arange(n_frames + 1, dtype=np.float64)
    cam_x = pan_amp[0] * (
        np.sin(2 * np.pi * t_axis / pan_period)
        + 0.35 * np.sin(2 * np.pi * t_axis / (pan_period * 0.37) + 1.1)
    )
    cam_y = pan_amp[1] * (
        np.sin(2 * np.pi * t_axis / (pan_period * 0.81) + 0.4)
    )

    # slowly varying target concurrency inside [lo, hi]
    target = lo + (hi - lo) * 0.5 * (
        1 + np.sin(2 * np.pi * t_axis / (n_frames * 0.9) - np.pi / 2)
    )

    class Obj:
        __slots__ = ("oid", "cx", "cy", "vx", "vy", "w", "h", "emb",
                     "t_exit")

    objects = []
    next_id = 1
    max_speed = 4.0

    def spawn(t):
        nonlocal next_id
        o = Obj()
        o.oid = next_id
        next_id += 1
        o.w = float(np.clip(rng.normal(70, 15), 35, 140))
        o.h = float(np.clip(rng.normal(185, 40), 90, 320))
        side = rng.integers(0, 4) if t > 0 else 4
        speed = rng.uniform(0.8, max_speed)
        ang = rng.uniform(0, 2 * np.pi)
        if side == 4:  # initial fill: anywhere, any direction
            o.cx = rng.uniform(80, W - 80) + cam_x[t]
            o.cy = rng.uniform(150, H - 60) + cam_y[t]
            o.vx, o.vy = speed * np.cos(ang), 0.3 * speed * np.sin(ang)
        else:  # edge entry, walking inward
            if side == 0:
                o.cx, o.vx = cam_x[t] - o.w / 2, abs(speed * np.cos(ang)) + 0.5
                o.cy, o.vy = rng.uniform(150, H - 60) + cam_y[t], 0.3 * speed * np.sin(ang)
            elif side == 1:
                o.cx, o.vx = W + o.w / 2 + cam_x[t], -abs(speed * np.cos(ang)) - 0.5
                o.cy, o.vy = rng.uniform(150, H - 60) + cam_y[t], 0.3 * speed * np.sin(ang)
            elif side == 2:
                o.cy, o.vy = cam_y[t] - o.h / 2, abs(0.3 * speed) + 0.2
                o.cx, o.vx = rng.uniform(80, W - 80) + cam_x[t], speed * np.cos(ang)
            else:
                o.cy, o.vy = H + o.h / 2 + cam_y[t], -abs(0.3 * speed) - 0.2
                o.cx, o.vx = rng.uniform(80, W - 80) + cam_x[t], speed * np.cos(ang)
        e = rng.normal(0, 1, emb_dim).astype(np.float32)
        o.emb = e / np.linalg.norm(e)
        # lifespan calibrated to MOT17-train churn (~0.10 identities
        # per frame aggregate; e.g. MOT17-04: 83 ids / 1050 frames)
        o.t_exit = t + int(rng.uniform(300, 2.0 * n_frames))
        return o

    for _ in range(int(target[0])):
        objects.append(spawn(0))

    gt, dets, embs, warps = {}, {}, {}, {}
    for t in range(1, n_frames + 1):
        # physics step: velocity random walk (walking pedestrians)
        for o in objects:
            o.vx = float(np.clip(o.vx + rng.normal(0, 0.15), -max_speed, max_speed))
            o.vy = float(np.clip(o.vy + rng.normal(0, 0.08), -max_speed * 0.5, max_speed * 0.5))
            o.cx += o.vx
            o.cy += o.vy

        # image-space boxes under the pan
        ox, oy = cam_x[t], cam_y[t]
        boxes = np.asarray(
            [[o.cx - o.w / 2 - ox, o.cy - o.h / 2 - oy,
              o.cx + o.w / 2 - ox, o.cy + o.h / 2 - oy] for o in objects],
            np.float64,
        ).reshape(len(objects), 4)

        # cull exits (fully out of frame or lifespan over)
        in_frame = (
            (boxes[:, 2] > 0) & (boxes[:, 0] < W)
            & (boxes[:, 3] > 0) & (boxes[:, 1] < H)
        )
        alive = [
            (o, b) for (o, b), ok in zip(zip(objects, boxes), in_frame)
            if ok and t < o.t_exit
        ]
        objects = [o for o, _ in alive]
        boxes = np.asarray([b for _, b in alive], np.float64).reshape(
            len(alive), 4
        )

        # churn: top up toward the concurrency target
        deficit = int(target[t]) - len(objects)
        for _ in range(max(deficit, 0)):
            objects.append(spawn(t))
        if deficit > 0:
            extra = np.asarray(
                [[o.cx - o.w / 2 - ox, o.cy - o.h / 2 - oy,
                  o.cx + o.w / 2 - ox, o.cy + o.h / 2 - oy]
                 for o in objects[-deficit:]], np.float64,
            ).reshape(deficit, 4)
            boxes = np.concatenate([boxes, extra], 0)

        G = len(objects)
        # visibility: fraction NOT covered by any closer object
        # (MOT convention: larger y2 = closer to camera)
        vis = np.ones(G)
        if G > 1:
            x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
            y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
            x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
            y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            closer = boxes[None, :, 3] > boxes[:, None, 3]  # j closer than i
            cover = np.where(closer, inter / np.maximum(area[:, None], 1e-9), 0.0)
            np.fill_diagonal(cover, 0.0)
            vis = np.clip(1.0 - cover.max(axis=1), 0.0, 1.0)
        # clip visibility by frame boundary overlap too
        bx1 = np.clip(boxes[:, 0], 0, W)
        by1 = np.clip(boxes[:, 1], 0, H)
        bx2 = np.clip(boxes[:, 2], 0, W)
        by2 = np.clip(boxes[:, 3], 0, H)
        in_area = np.clip(bx2 - bx1, 0, None) * np.clip(by2 - by1, 0, None)
        full = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        vis = vis * in_area / np.maximum(full, 1e-9)

        keep_gt = vis >= 0.25
        ids = np.asarray([o.oid for o in objects])
        gt[t] = (ids[keep_gt], boxes[keep_gt].copy(), vis[keep_gt].copy())

        # detector model (FRCNN-calibrated)
        det_rows, emb_rows = [], []
        for i, o in enumerate(objects):
            v = vis[i]
            # miss probability: benchmark-detector-like HIGH recall —
            # occluded objects usually still yield a low-conf detection
            # (the premise of BYTE-style second-stage association); only
            # heavy occlusion suppresses the box entirely
            p_miss = 0.01 + 0.6 * (1.0 - v) ** 3
            if rng.random() < p_miss:
                continue
            jitter = rng.normal(0, 2.0 + 4.0 * (1 - v), 4)
            b = boxes[i] + jitter
            if v > 0.7:
                conf = float(np.clip(rng.normal(0.97, 0.05), 0.5, 1.0))
            else:
                conf = float(np.clip(rng.normal(0.45 + 0.5 * v, 0.15), 0.05, 0.95))
            det_rows.append([b[0], b[1], b[2], b[3], conf, 0.0])
            e = o.emb + rng.normal(0, 0.03 + 0.18 * (1 - v), emb_dim).astype(np.float32)
            emb_rows.append(e / np.linalg.norm(e))
        # false positives: ~0.7/frame, low-conf tail like FRCNN's
        for _ in range(rng.poisson(0.7)):
            fw = np.clip(rng.normal(70, 25), 30, 150)
            fh = np.clip(rng.normal(180, 60), 70, 330)
            fx = rng.uniform(0, W - fw)
            fy = rng.uniform(0, H - fh)
            det_rows.append([fx, fy, fx + fw, fy + fh,
                             float(rng.uniform(0.05, 0.75)), 0.0])
            e = rng.normal(0, 1, emb_dim).astype(np.float32)
            emb_rows.append(e / np.linalg.norm(e))
        dets[t] = np.asarray(det_rows, np.float32).reshape(len(det_rows), 6)
        embs[t] = np.asarray(emb_rows, np.float32).reshape(len(emb_rows), emb_dim)

        # GT warp mapping frame t-1 -> t coords: pure camera translation
        dxw = float(cam_x[t - 1] - cam_x[t])
        dyw = float(cam_y[t - 1] - cam_y[t])
        warps[t] = np.asarray([[1.0, 0.0, dxw], [0.0, 1.0, dyw]], np.float32)

    return gt, dets, embs, warps
