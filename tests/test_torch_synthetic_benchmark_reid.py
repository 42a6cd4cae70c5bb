"""Port parity: the synthetic accuracy benchmark's embedding trackers
(DeepOC-SORT, StrongSORT, BoT-SORT, BoostTrack, HybridSORT, fed the
scene's 32-wide embeddings) in motcpp_tpu_torch against the JAX
package's ``scripts/synthetic_benchmark.py``, on the CPU, as
``tests/test_torch_synthetic_benchmark.py`` holds the motion-only ones:
the first 100 frames, the exact JV, every frame's rows and the printed
row.
"""

import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from ablation_parity import first_difference
from motcpp_tpu_torch.scripts import synthetic_benchmark as port_tool
from synthetic_parity import FRAMES, both


@pytest.mark.parametrize("tracker", sorted(port_tool.EMB_TRACKERS))
def test_embedding_row_equals_the_jax_tools(tracker, monkeypatch):
    port_line, jax_line, port_rows, jax_rows = both(monkeypatch, tracker)
    assert len(port_rows) == len(jax_rows) == FRAMES
    assert first_difference(port_rows, jax_rows) is None
    assert port_line == jax_line
