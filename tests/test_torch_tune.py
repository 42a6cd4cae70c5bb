"""Port parity: the hyperparameter tuner of motcpp_tpu_torch
(``motcpp_tpu_torch/scripts/tune.py``) against the JAX package's
``scripts/tune.py``, loaded with ``importlib``, on the CPU: the same
search-space draws (the port's YAML reader and ``TrackerConfig.sample``),
the same trials over MOT17-mini and the same printed lines, scores
included. The JAX tool writes through its package's native IO, so the
test asks for ``jax_native_parser`` (ROADMAP queue 3).
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from jax_cases import jax_native_parser  # noqa: F401
from motcpp_tpu_torch.scripts import tune

ROOT = Path(__file__).resolve().parent.parent


def stdout_of(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_tune_prints_the_jax_tools_lines(jax_native_parser):
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_tune", ROOT / "scripts" / "tune.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    argv = ["bytetrack", "--trials", "3", "--cpu"]
    got = stdout_of(tune.main, argv)
    assert got == stdout_of(jax_tool.main, argv)
    assert got.startswith("# default    HOTA=") and "\n== best ==\n" in got
    assert got.count("# trial ") == 2


def test_evaluate_params_writes_each_sequences_rows(tmp_path):
    """The kernel's route (its plain version on the CPU) scores as the
    plain auction, and each sequence's rows land in the work directory."""
    root = ROOT / "assets" / "MOT17-mini" / "train"
    got = {}
    for lap in ("auction_pallas", "auction"):
        work = tmp_path / lap
        work.mkdir()
        got[lap] = tune.evaluate_params("bytetrack", {}, root, 8, work,
                                        device="cpu", lap_impl=lap)
        assert sorted(p.name for p in work.glob("*.txt")) == [
            "MOT17-02-FRCNN.txt", "MOT17-04-FRCNN.txt"]
    assert {k: v for k, v in got["auction_pallas"].items()
            if not k.startswith("_")} == {
        k: v for k, v in got["auction"].items() if not k.startswith("_")}
    assert got["auction"]["HOTA"] > 0
    with pytest.raises(ValueError, match="Unknown tracker"):
        tune.evaluate_params("nope", {}, root, 8, tmp_path, device="cpu")
