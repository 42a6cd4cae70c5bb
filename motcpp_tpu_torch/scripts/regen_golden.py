#!/usr/bin/env python3
"""Regenerate the golden tracker outputs on MOT17-mini through the port,
and compare them with the committed ones.

Counterpart of the JAX package's ``scripts/regen_golden.py``: the same
two sets through the port's CLI (``motcpp_tpu_torch/cli.py``) with the
exact JV solver and ``--max-dets 128 --max-tracks 128``:

  golden       ablation-window runs (the reference eval's offset logic,
               tools/motcpp_eval.cpp:336-375): 4+8 frames scored against
               the bundled GT.
  golden_long  long-horizon runs (--no-ablation, first 150 det frames):
               spans >2x every lifecycle constant, so lost-track aging,
               max_age deaths, duplicate removal and OCR long-gap
               re-matches are pinned on real detections.

It writes ``motcpp_tpu_torch/_build/golden/<tracker>`` and
``motcpp_tpu_torch/_build/golden_long/<tracker>`` (never ``tests/``) and
prints, for each set, whether it equals the committed ``tests/golden``
or ``tests/golden_long`` set byte for byte, and if not the first file
and line that differ. ``python -m
motcpp_tpu_torch.scripts.update_accuracy_table`` scores the long sets.

Runs on the CUDA device unless given ``--cpu``.

Usage: python -m motcpp_tpu_torch.scripts.regen_golden [tracker ...] [--cpu]   (default: all 9)
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

from motcpp_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent.parent
MOT_MINI = ROOT / "assets" / "MOT17-mini" / "train"
BUILD = ROOT / "motcpp_tpu_torch" / "_build"
COMMITTED = ROOT / "tests"
LONG_FRAMES = 150
SETS = ("golden", "golden_long")

# all 9: the CMC/ReID trackers are deterministic here too — the eval
# runs with dummy 1080p frames (ECC/SOF on constant images yield the
# identity warp) and no embedding files ship with MOT17-mini
TRACKERS = ["sort", "bytetrack", "ocsort", "boosttrack", "ucmctrack",
            "deepocsort", "strongsort", "botsort", "hybridsort"]


def write_set(tracker, kind, root=None, device="cuda") -> Path:
    """Write ``tracker``'s ``kind`` set ("golden" or "golden_long")
    through the port's CLI on ``device`` into ``<root>/<kind>/<tracker>``
    (``root`` defaults to ``motcpp_tpu_torch/_build``), replacing what
    was there. Returns the set's directory."""
    from motcpp_tpu_torch.cli import main as cli_main

    if kind not in SETS:
        raise ValueError(f"unknown golden set {kind!r}; valid: {SETS}")
    cpu = resolve_device(device).type == "cpu"
    out = Path(BUILD if root is None else root) / kind / tracker
    if out.exists():
        shutil.rmtree(out)
    argv = [str(MOT_MINI), str(out), tracker,
            "--max-dets", "128", "--max-tracks", "128"]
    if cpu:
        argv.append("--cpu")
    if kind == "golden_long":
        argv += ["--no-ablation", "--limit-frames", str(LONG_FRAMES)]
    rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"the CLI exited {rc} on {tracker} ({kind})")
    return out


def differing_line(got: bytes, want: bytes):
    """None where the two files' bytes are equal, else the 1-based line
    where they first differ."""
    if got == want:
        return None
    a, b = got.split(b"\n"), want.split(b"\n")
    return next((i for i, (x, y) in enumerate(zip(a, b), 1) if x != y),
                min(len(a), len(b)) + 1)


def first_difference(got, want):
    """None where the directories ``got`` and ``want`` hold the same
    ``*.txt`` files with the same bytes; else where they first differ:
    a file one side lacks, or ``"<file>:<line>"``."""
    got, want = Path(got), Path(want)
    names = sorted({p.name for p in got.glob("*.txt")}
                   | {p.name for p in want.glob("*.txt")})
    if not names:
        return f"{want} holds no result files"
    for name in names:
        if not (got / name).exists():
            return f"{name} (only in {want})"
        if not (want / name).exists():
            return f"{name} (only in {got})"
        line = differing_line((got / name).read_bytes(),
                              (want / name).read_bytes())
        if line is not None:
            return f"{name}:{line}"
    return None


def verdict(got, committed) -> str:
    """Whether ``got`` (a set's directory or one file) equals the
    committed ``committed`` byte for byte, and if not where they first
    differ."""
    got, committed = Path(got), Path(committed)
    if got.is_dir():
        diff = first_difference(got, committed)
    else:
        line = differing_line(got.read_bytes(), committed.read_bytes())
        diff = None if line is None else f"line {line}"
    where = committed.relative_to(ROOT)
    return (f"equals {where} byte for byte" if diff is None
            else f"differs from {where} at {diff}")


def write_and_compare(path, text, committed) -> str:
    """Write ``text`` to ``path``; its :func:`verdict` against
    ``committed``."""
    Path(path).write_text(text)
    return verdict(path, committed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trackers", nargs="*", default=TRACKERS)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)
    if not MOT_MINI.exists():
        print("MOT17-mini assets unavailable")
        return 1
    for trk in args.trackers:
        for kind in SETS:
            out = write_set(trk, kind, device=device)
            print(f"regenerated {out}: "
                  + verdict(out, COMMITTED / kind / trk))
    return 0


if __name__ == "__main__":
    sys.exit(main())
