#!/usr/bin/env python3
"""Compute HOTA / CLEAR / Identity metrics for MOT result folders.

Counterpart of the JAX package's ``scripts/eval_mot.py``: the same
flags, the same table and ``--json`` output character for character,
the same exit codes, scored by the port's ``metrics/mot_metrics.py``.
It is host work only (no tracker runs), so it takes no device.

Usage:
    python -m motcpp_tpu_torch.scripts.eval_mot --gt_folder <mot_root> \
        --trackers_folder <results_dir> [--classes 1] [--json]

The tracker folder holds one <sequence>.txt per sequence; GT is read
from <mot_root>/<sequence>/gt/gt.txt. When result frames were written
with an ablation offset (reference: tools/motcpp_eval.cpp:336-375), they
already align with GT frame numbering.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from motcpp_tpu_torch.metrics import combine_metrics, evaluate_sequence

KEYS = ["HOTA", "MOTA", "IDF1", "DetA", "AssA", "MOTP", "IDSW", "FP", "FN",
        "MT", "ML"]


def _display(m: dict) -> dict:
    """Drop pooling accumulators (non-JSON-serializable arrays)."""
    return {k: v for k, v in m.items() if not k.startswith("_")}


def evaluate(gt_folder, trackers_folder, classes=(1,)) -> list:
    """The metrics of each ``<sequence>.txt`` of ``trackers_folder``
    against ``<gt_folder>/<sequence>/gt/gt.txt``, in file-name order,
    each with its ``"seq"``; a sequence without GT is skipped with a
    line on stderr."""
    gt_root = Path(gt_folder)
    rows = []
    for res_file in sorted(Path(trackers_folder).glob("*.txt")):
        seq = res_file.stem
        gt_file = gt_root / seq / "gt" / "gt.txt"
        if not gt_file.exists():
            print(f"# no GT for {seq}, skipping", file=sys.stderr)
            continue
        m = evaluate_sequence(gt_file, res_file, tuple(classes))
        m["seq"] = seq
        rows.append(m)
    return rows


def _cells(m: dict) -> str:
    return "".join(f"{m[k]:8.2f}" if isinstance(m[k], float)
                   else f"{m[k]:8d}" for k in KEYS)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_folder", required=True)
    ap.add_argument("--trackers_folder", required=True)
    ap.add_argument("--classes", type=int, nargs="*", default=[1])
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    rows = evaluate(args.gt_folder, args.trackers_folder, args.classes)
    if not rows:
        print("No sequences evaluated", file=sys.stderr)
        return 1

    if args.json:
        combined = _display(combine_metrics(rows))
        combined["seq"] = "COMBINED"
        print(json.dumps([_display(m) for m in rows] + [combined]))
        return 0

    hdr = f"{'seq':22s}" + "".join(f"{k:>8s}" for k in KEYS)
    print(hdr)
    print("-" * len(hdr))
    for m in rows:
        print(f"{m['seq']:22s}" + _cells(m))
    # combined: pooled accumulators (TrackEval semantics), not an
    # average of per-sequence ratios
    print("-" * len(hdr))
    print(f"{'COMBINED':22s}" + _cells(combine_metrics(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
