#!/usr/bin/env python3
"""Regenerate the converted-checkpoint ReID goldens through the port, and
compare them with the committed ``tests/golden_reid``.

Counterpart of the JAX package's ``scripts/regen_golden_reid.py``: it
pins the whole pretrained-ReID chain, a torchreid-layout checkpoint
converted by name (committed as
``tests/fixtures/osnet_x0_25_converted.npz``; ``python -m
motcpp_tpu_torch.scripts.convert_reid_weights`` writes that layout) ->
the port's ``ReIDBackend`` from real MOT17-mini pixels -> StrongSORT and
BoT-SORT association. Two kinds of file:

  forward_fingerprint.json  the backend's features of three boxes of a
                            seeded synthetic image (no jpg): dimension,
                            norms, pairwise cosines and the first eight
                            values, each rounded to 1e-4;
  <tracker>_MOT17-02.json   each frame's rows of StrongSORT and BoT-SORT
                            over the four bundled MOT17-02 jpgs, with
                            features from the pixels.

It writes ``motcpp_tpu_torch/_build/golden_reid/`` (never ``tests/``) and
prints whether each file equals the committed one byte for byte. The
backend runs OSNet's module forward (no CUDA kernel, as the JAX backend
runs its Flax module), in float32 with TF32 off. The jpgs are read with
cv2, else PIL; without either the tracker rows cannot be made and the
tool raises.

Runs on the CUDA device unless given ``--cpu``.

Usage: python -m motcpp_tpu_torch.scripts.regen_golden_reid [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.scripts.regen_golden import write_and_compare

ROOT = Path(__file__).resolve().parent.parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "osnet_x0_25_converted.npz"
GOLDEN = ROOT / "motcpp_tpu_torch" / "_build" / "golden_reid"
COMMITTED = ROOT / "tests" / "golden_reid"
SEQ = ROOT / "assets" / "MOT17-mini" / "train" / "MOT17-02-FRCNN"
N_FRAMES = 4  # the bundled jpg frames
TRACKERS = ("strongsort", "botsort")


def load_frames_and_dets():
    """(frames, dets_by_frame) for the bundled MOT17-02 jpgs; raises
    RuntimeError where a frame cannot be read (neither cv2 nor PIL
    imports, or the file does not decode)."""
    from motcpp_tpu_torch.data.mot17 import imread

    dets_by_frame = {}
    for ln in (SEQ / "det" / "det.txt").read_text().splitlines():
        f = [float(x) for x in ln.split(",")[:7]]
        t = int(f[0])
        if t > N_FRAMES:
            continue
        x, y, w, h, conf = f[2], f[3], f[4], f[5], f[6]
        dets_by_frame.setdefault(t, []).append([x, y, x + w, y + h, conf, 0])
    frames = {}
    for t in range(1, N_FRAMES + 1):
        path = SEQ / "img1" / f"{t:06d}.jpg"
        frames[t] = imread(path)
        if frames[t] is None:
            raise RuntimeError(f"cannot read {path}: the ReID goldens need "
                               "cv2 or PIL to decode the MOT17-02 frames")
    return frames, {
        t: np.asarray(v, np.float32) for t, v in dets_by_frame.items()
    }


def forward_fingerprint(backend) -> dict:
    """The backend's features of three boxes of a seeded synthetic image,
    summarised as the JAX tool pins them."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (256, 320, 3)).astype(np.uint8)
    boxes = np.asarray(
        [[10, 10, 120, 240], [150, 20, 300, 250], [0, 0, 320, 256]],
        np.float32,
    )
    feats = backend.get_features(boxes, img)
    return {
        "feature_dim": int(feats.shape[1]),
        "norms": [round(float(x), 4) for x in np.linalg.norm(feats, axis=1)],
        "pairwise_cos": [
            round(float(feats[i] @ feats[j]), 4)
            for i in range(3) for j in range(i + 1, 3)
        ],
        "first8": [round(float(x), 4) for x in feats[0, :8]],
    }


def run_tracker(name, backend, device="cuda"):
    """``name``'s rows over the MOT17-02 frames on ``device``, features
    from the pixels through ``backend``: [frame, x1, y1, x2, y2, id,
    conf, cls, det_ind], each value rounded to 1e-2."""
    import motcpp_tpu_torch

    resolve_device(device)
    frames, dets_by_frame = load_frames_and_dets()
    tr = motcpp_tpu_torch.create_tracker(name, max_tracks=64, max_dets=32,
                                         device=device)
    rows = []
    for t in range(1, N_FRAMES + 1):
        dets = dets_by_frame.get(t, np.zeros((0, 6), np.float32))
        img = frames[t]
        # live chain: features from PIXELS through the converted weights
        embs = backend.get_features(dets[:, :4], img)
        out = tr.update(dets, img, embs)
        for r in out:
            rows.append([t] + [round(float(v), 2) for v in r])
    return rows


def main(argv=None):
    from motcpp_tpu_torch.appearance.reid import ReIDBackend
    from motcpp_tpu_torch.utils.profiling import exact_float32

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    backend = ReIDBackend(weights=str(FIXTURE), device=device)
    GOLDEN.mkdir(parents=True, exist_ok=True)
    with exact_float32():
        name = "forward_fingerprint.json"
        print(f"{name}: " + write_and_compare(
            GOLDEN / name, json.dumps(forward_fingerprint(backend), indent=1)
            + "\n", COMMITTED / name))
        for tracker in TRACKERS:
            rows = run_tracker(tracker, backend, device)
            name = f"{tracker}_MOT17-02.json"
            print(f"{tracker}: {len(rows)} golden rows; {name}: "
                  + write_and_compare(GOLDEN / name, json.dumps(rows) + "\n",
                                      COMMITTED / name))
    print(f"wrote {GOLDEN}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
