"""Runs the synthetic accuracy benchmark in both packages for the port's
tests.

``both(monkeypatch, tracker)`` runs the port's
``motcpp_tpu_torch/scripts/synthetic_benchmark.py::run_table`` on the
CPU and the JAX package's ``scripts/synthetic_benchmark.py`` (its
``main``, loaded with ``importlib``) over the first FRAMES frames of the
tool's scene with the exact JV, and returns the port's table row, the
JAX tool's printed row and each package's emitted rows a frame
(recorded as ``tests/ablation_parity.py`` records them).
"""

import contextlib
import importlib.util
import io

import motcpp_tpu
import motcpp_tpu_torch
from ablation_parity import ROOT, recording
from motcpp_tpu_torch.scripts import synthetic_benchmark as port_tool

# the first FRAMES of the tool's 300-frame scene: its draws are made
# frame by frame, so a shorter scene is the longer one's prefix
FRAMES = 100


def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_synthetic_benchmark",
        ROOT / "scripts" / "synthetic_benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_tool = load_jax_tool()


def without_seconds(line):
    """A table row without its trailing wall seconds."""
    return line.rsplit("   (", 1)[0]


def both(monkeypatch, tracker):
    """(port row line, JAX row line, both without seconds; port rows,
    JAX rows: [each frame's (M, 8) output])."""
    port_rows, jax_rows = {}, {}
    monkeypatch.setattr(motcpp_tpu_torch, "create_tracker", recording(
        motcpp_tpu_torch.create_tracker, port_rows))
    monkeypatch.setattr(motcpp_tpu, "create_tracker", recording(
        motcpp_tpu.create_tracker, jax_rows))
    table = port_tool.run_table(FRAMES, trackers=[tracker], device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_tool.main(["--frames", str(FRAMES), "--trackers",
                              tracker]) == 0
    header, rule, jax_line = out.getvalue().splitlines()
    assert header == port_tool.HEADER and rule == "-" * len(header)
    return (without_seconds(port_tool.row_line(tracker, table[tracker])),
            without_seconds(jax_line), port_rows[tracker], jax_rows[tracker])
