"""Port parity: the MOT metrics of motcpp_tpu_torch (HOTA, CLEAR,
IDF1; ``metrics/``, a copy of the JAX package's numpy and scipy code).

On every (gt, tests/golden_long/<tracker>/*.txt) pair of the nine
trackers, ``evaluate_sequence`` and ``combine_metrics`` equal the JAX
package's exactly, and the combined rows equal
tests/accuracy_mot17mini.json as tests/test_accuracy_real.py holds the
JAX package's. The cases of tests/test_metrics.py and
tests/test_accuracy_real.py run against the port.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

import motcpp_tpu.metrics as jax_metrics
import motcpp_tpu_torch.metrics as port_metrics
import test_accuracy_real
import test_metrics
import torch_threads  # noqa: F401  (torch at one thread)
from jax_cases import jax_cases, run_jax_case

HERE = Path(__file__).resolve().parent
MOT_MINI = HERE.parent / "assets" / "MOT17-mini" / "train"
GOLDEN_LONG = HERE / "golden_long"
EXPECTED = json.loads((HERE / "accuracy_mot17mini.json").read_text())
TRACKERS = sorted(p.name for p in GOLDEN_LONG.iterdir() if p.is_dir())
METRIC_NAMES = ["clear_metrics", "combine_metrics", "evaluate_sequence",
                "hota_metrics", "identity_metrics", "load_mot_file"]


def assert_same_metrics(got: dict, want: dict):
    """Every key, of the same type, equal to the bit (NaN equal to NaN;
    the per-alpha arrays elementwise)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w,
                                                         equal_nan=True), k
        else:
            assert g == w or (isinstance(w, float) and math.isnan(w)
                              and math.isnan(g)), (k, g, w)


@pytest.mark.parametrize("tracker", TRACKERS)
def test_golden_long_scores_equal_the_jax_package(tracker):
    got_rows, want_rows = [], []
    for res in sorted((GOLDEN_LONG / tracker).glob("*.txt")):
        gt = MOT_MINI / res.stem / "gt" / "gt.txt"
        got_rows.append(port_metrics.evaluate_sequence(gt, res))
        want_rows.append(jax_metrics.evaluate_sequence(gt, res))
        assert_same_metrics(got_rows[-1], want_rows[-1])
    assert len(got_rows) == 2
    got = port_metrics.combine_metrics(got_rows)
    assert_same_metrics(got, jax_metrics.combine_metrics(want_rows))
    want = EXPECTED[tracker]
    for key in ("HOTA", "MOTA", "IDF1", "DetA", "AssA", "MOTP"):
        assert got[key] == pytest.approx(want[key], abs=0.05), key
    for key in ("IDSW", "FP", "FN", "MT", "ML"):
        assert got[key] == want[key], key


PORT_MODULES = {"motcpp_tpu.metrics": port_metrics,
                "motcpp_tpu.metrics.mot_metrics": port_metrics.mot_metrics}


@pytest.mark.parametrize("case,name,kwargs", jax_cases(
    test_metrics, sorted(n for n in dir(test_metrics)
                         if n.startswith("test_"))))
def test_jax_metric_cases_pass_against_the_port(case, name, kwargs,
                                                monkeypatch, tmp_path):
    run_jax_case(test_metrics, name, kwargs, monkeypatch,
                 {n: getattr(port_metrics, n) for n in METRIC_NAMES
                  if hasattr(test_metrics, n)}, PORT_MODULES,
                 tmp_path=tmp_path)


@pytest.mark.parametrize("case,name,kwargs", jax_cases(
    test_accuracy_real, ["test_accuracy_pinned", "test_accuracy_sanity_floors",
                         "test_warmup_window_diagnosis"]))
def test_jax_accuracy_cases_pass_against_the_port(case, name, kwargs,
                                                  monkeypatch, tmp_path):
    run_jax_case(test_accuracy_real, name, kwargs, monkeypatch, {},
                 PORT_MODULES, tmp_path=tmp_path)


def test_the_port_module_is_what_the_cases_read(monkeypatch):
    """The redirection above reaches the port: inside it, the JAX
    package's import path yields the port's functions."""
    monkeypatch.setitem(__import__("sys").modules, "motcpp_tpu.metrics",
                        port_metrics)
    from motcpp_tpu.metrics import evaluate_sequence

    assert evaluate_sequence is port_metrics.evaluate_sequence
    assert evaluate_sequence is not jax_metrics.evaluate_sequence
