#!/usr/bin/env python3
"""Recompute the MOT17-mini accuracy table from the port's long-horizon
goldens.

Counterpart of the JAX package's ``scripts/update_accuracy_table.py``:
the same keys and rounding, the same markdown table, scored by the
port's metrics. Run AFTER ``python -m
motcpp_tpu_torch.scripts.regen_golden``, which writes the sets it reads
(``motcpp_tpu_torch/_build/golden_long/<tracker>``); it writes
``motcpp_tpu_torch/_build/accuracy_mot17mini_torch.json``. The committed
``tests/accuracy_mot17mini.json`` is the JAX package's and is never
written. Host work only: it runs no tracker.

Usage: python -m motcpp_tpu_torch.scripts.update_accuracy_table
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from motcpp_tpu_torch.metrics import combine_metrics, evaluate_sequence

ROOT = Path(__file__).resolve().parent.parent.parent
BUILD = ROOT / "motcpp_tpu_torch" / "_build"
MOT_MINI = ROOT / "assets" / "MOT17-mini" / "train"
GOLDEN_LONG = BUILD / "golden_long"
TABLE = BUILD / "accuracy_mot17mini_torch.json"
COLS = ["HOTA", "MOTA", "IDF1", "DetA", "AssA", "IDSW", "FP", "FN", "MT",
        "ML"]


def score_table(golden_long=None) -> dict:
    """{tracker: combined metrics} of every tracker folder under
    ``golden_long`` (default: :data:`GOLDEN_LONG`), each ``<seq>.txt``
    scored against MOT17-mini's ``<seq>/gt/gt.txt``; the ratios rounded
    to two decimals, the counts exact, as the JAX tool writes them."""
    golden_long = Path(GOLDEN_LONG if golden_long is None else golden_long)
    if not golden_long.is_dir():
        raise FileNotFoundError(
            f"{golden_long} does not exist: run `python -m "
            "motcpp_tpu_torch.scripts.regen_golden` first, which writes "
            "the long-horizon sets this table scores")
    table = {}
    for trk_dir in sorted(golden_long.iterdir()):
        if not trk_dir.is_dir():
            continue
        rows = [evaluate_sequence(MOT_MINI / res.stem / "gt" / "gt.txt", res)
                for res in sorted(trk_dir.glob("*.txt"))]
        comb = combine_metrics(rows)
        table[trk_dir.name] = {
            **{k: round(comb[k], 2)
               for k in ("HOTA", "MOTA", "IDF1", "DetA", "AssA", "MOTP")},
            **{k: comb[k] for k in ("IDSW", "FP", "FN", "MT", "ML")},
        }
    return table


def markdown(table: dict) -> list:
    """The JAX tool's markdown table of ``table``, best HOTA first."""
    lines = ["| tracker | " + " | ".join(COLS) + " |",
             "|---" * (len(COLS) + 1) + "|"]
    for trk in sorted(table, key=lambda t: -table[t]["HOTA"]):
        m = table[trk]
        cells = [f"{m[c]:.2f}" if isinstance(m[c], float) else str(m[c])
                 for c in COLS]
        lines.append(f"| {trk} | " + " | ".join(cells) + " |")
    return lines


def main():
    table = score_table()
    TABLE.parent.mkdir(parents=True, exist_ok=True)
    TABLE.write_text(json.dumps(table, indent=1) + "\n")
    print(f"wrote {TABLE}\n")
    print("\n".join(markdown(table)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
