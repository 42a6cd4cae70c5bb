"""Port parity: the synthetic accuracy benchmark of motcpp_tpu_torch
(``motcpp_tpu_torch/scripts/synthetic_benchmark.py``) against the JAX
package's ``scripts/synthetic_benchmark.py``, on the CPU: the scene, the
configurations and the motion-only trackers' rows.

The scene must be the JAX tool's arrays exactly. Each tracker runs the
first 100 frames of the tool's scene in both packages with the exact JV
(``tests/synthetic_parity.py``): every frame's emitted rows must agree
(ids, classes and detection indices exact, boxes within 1e-3 px and
confidences within 1e-5, ``tests/ablation_parity.py::first_difference``:
XLA's fused multiply-adds move the Kalman states in their last bits,
ROADMAP queue 3), and the table row must be the JAX tool's to the printed
two decimals. The embedding trackers are in
``tests/test_torch_synthetic_benchmark_reid.py``: under ``--dist
loadfile`` one file is one worker's load.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from ablation_parity import first_difference
from motcpp_tpu_torch.scripts import synthetic_benchmark as port_tool
from synthetic_parity import FRAMES, both, jax_tool

MOTION_TRACKERS = ["sort", "bytetrack", "ocsort", "ucmctrack"]


def same(a, b):
    """Arrays, or tuples of arrays, equal in dtype and value."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def test_scene_and_configurations_are_the_jax_tools():
    """The same configurations, and the scene's ground truth, detections
    and embeddings equal to the JAX tool's; a shorter scene is the
    longer one's prefix."""
    assert port_tool.TRACKERS == jax_tool.TRACKERS
    assert port_tool.EMB_TRACKERS == jax_tool.EMB_TRACKERS
    assert sorted(set(port_tool.TRACKERS) - port_tool.EMB_TRACKERS) == sorted(
        MOTION_TRACKERS)
    got, want = port_tool.make_scene(300, 24), jax_tool.make_scene(300, 24)
    for g, w, prefix in zip(got, want, port_tool.make_scene(FRAMES, 24)):
        assert list(g) == list(w) == list(range(1, 301))
        assert all(same(g[t], w[t]) for t in g)
        assert all(same(prefix[t], g[t]) for t in prefix)


@pytest.mark.parametrize("tracker", MOTION_TRACKERS)
def test_motion_row_equals_the_jax_tools(tracker, monkeypatch):
    port_line, jax_line, port_rows, jax_rows = both(monkeypatch, tracker)
    assert len(port_rows) == len(jax_rows) == FRAMES
    assert first_difference(port_rows, jax_rows) is None
    assert port_line == jax_line


def test_main_prints_the_table_and_the_kernel_lap_is_the_plain_auction(
        capsys):
    """``main --cpu`` prints the JAX tool's header and one row a tracker;
    on the CPU ``--lap auction_pallas`` runs the kernel's plain version,
    so its table is the plain auction's."""
    assert port_tool.main(["--cpu", "--frames", "30", "--trackers", "sort",
                           "bytetrack", "--lap", "auction_pallas"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == port_tool.HEADER and len(lines) == 4
    assert [ln.split()[0] for ln in lines[2:]] == ["sort", "bytetrack"]
    kernel = port_tool.run_table(30, trackers=["bytetrack"],
                                 lap="auction_pallas", device="cpu")
    plain = port_tool.run_table(30, trackers=["bytetrack"], lap="auction",
                                device="cpu")
    for table in (kernel, plain):
        del table["bytetrack"]["seconds"]
    assert kernel == plain
    with pytest.raises(SystemExit, match="unknown tracker"):
        port_tool.run_table(30, trackers=["nope"], device="cpu")
