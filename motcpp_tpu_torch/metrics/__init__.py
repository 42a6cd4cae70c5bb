"""Tracking-quality metrics: HOTA, CLEAR (MOTA/MOTP), Identity (IDF1).

A copy of ``motcpp_tpu/metrics/__init__.py``.

The reference delegates metrics to a downloaded TrackEval checkout
(reference: scripts/eval_mot.py:1-120). This environment has zero
egress, so the three metric families TrackEval computes for the
reference's benchmark tables (README.md Benchmarks) are implemented
here directly, following the published algorithm definitions
(Luiten et al., "HOTA: A Higher Order Metric for Evaluating
Multi-object Tracking", IJCV 2020; CLEAR-MOT; IDF1).
"""

from motcpp_tpu_torch.metrics.mot_metrics import (
    clear_metrics,
    combine_metrics,
    evaluate_sequence,
    hota_metrics,
    identity_metrics,
    load_mot_file,
)

__all__ = [
    "clear_metrics",
    "combine_metrics",
    "evaluate_sequence",
    "hota_metrics",
    "identity_metrics",
    "load_mot_file",
]
