#!/usr/bin/env python3
"""Regenerate the CMC-active and embedding-active goldens through the
port, and compare them with the committed ``tests/golden_cmc``.

Counterpart of the JAX package's ``scripts/regen_golden_cmc.py``: a
deterministic synthetic moving-camera scene
(``data/synthetic.py::camera_pan_scene``) drives live CMC estimation
(ECC / SOF / the sparse-flow estimator in torch) and real per-identity
embeddings with dropout gaps through the five CMC/ReID trackers, and the
MOT rows are written as the JAX tool writes them, to
``motcpp_tpu_torch/_build/golden_cmc/<name>.txt`` (never ``tests/``),
each compared byte for byte with ``tests/golden_cmc/<name>.txt``.

A run marked ``needs_cv2`` estimates its camera motion with OpenCV; where
cv2 does not import, its estimator gives the identity warp and its rows
cannot match, so it is not run and is reported so.

Runs on the CUDA device unless given ``--cpu``.

Usage: python -m motcpp_tpu_torch.scripts.regen_golden_cmc [name ...] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.scripts.regen_golden import write_and_compare

ROOT = Path(__file__).resolve().parent.parent.parent
GOLDEN = ROOT / "motcpp_tpu_torch" / "_build" / "golden_cmc"
COMMITTED = ROOT / "tests" / "golden_cmc"

# (golden name, tracker, extra ctor kwargs, needs_cv2)
RUNS = [
    ("botsort_ecc", "botsort", dict(cmc_method="ecc"), True),
    ("botsort_sofjax", "botsort", dict(cmc_method="sof_jax"), False),
    ("strongsort_ecc", "strongsort", {}, True),
    ("deepocsort_sof", "deepocsort", {}, True),
    ("boosttrack_ecc", "boosttrack", {}, True),
    ("hybridsort_ecc", "hybridsort", {}, True),
]

# re-match gaps: object 2 drops frames 10-14, object 4 drops 8-9
DROPOUTS = {2: set(range(10, 15)), 4: {8, 9}}


def has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def run_scene(tracker_name: str, ctor_kwargs: dict, device="cuda") -> str:
    """Run one tracker over the pan scene on ``device``; returns MOT
    text."""
    import numpy as np

    import motcpp_tpu_torch
    from motcpp_tpu_torch.data import convert_to_mot_format
    from motcpp_tpu_torch.data.synthetic import camera_pan_scene

    resolve_device(device)
    try:
        import cv2

        cv2.setRNGSeed(0)  # SOF's RANSAC must be deterministic
    except ImportError:
        pass

    frames, dets_all, embs_all = camera_pan_scene(
        n_frames=30, dropout_frames=DROPOUTS
    )
    tracker = motcpp_tpu_torch.create_tracker(
        tracker_name, max_dets=16, max_tracks=32, device=device,
        **ctor_kwargs
    )
    lines = []
    for t, (img, dets, embs) in enumerate(zip(frames, dets_all, embs_all)):
        tracks = tracker.update(dets, img, embs)
        for row in convert_to_mot_format(np.asarray(tracks), t + 1):
            lines.append(
                ",".join(
                    [f"{int(v)}" for v in row[:6]]
                    + [f"{row[6]:.6f}", "-1", "-1", "-1"]
                )
            )
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*",
                    help="golden names to regenerate (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)
    GOLDEN.mkdir(parents=True, exist_ok=True)
    for name, tracker, kwargs, needs_cv2 in RUNS:
        if args.names and name not in args.names:
            continue
        if needs_cv2 and not has_cv2():
            print(f"{name}: not run (its camera motion needs cv2, which "
                  "does not import here)")
            continue
        text = run_scene(tracker, kwargs, device)
        n_ids = len({line.split(",")[1] for line in text.strip().splitlines()})
        print(f"regenerated {name}: {len(text.splitlines())} rows, {n_ids} "
              f"ids; " + write_and_compare(GOLDEN / f"{name}.txt", text,
                                           COMMITTED / f"{name}.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
