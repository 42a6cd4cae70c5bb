"""Port parity: the ablation scoreboard's cadence probes and its replica
mode (``motcpp_tpu_torch/scripts/ablation_benchmark.py``) against the JAX
package's ``scripts/ablation_benchmark.py``, on the CPU at 150 frames:
bench.py's DEPLOYED cadence points (BoT-SORT and DeepOC-SORT at 8,
BoostTrack at 2) and ByteTrack on the no-pan scene without injected warps.
Every metric equal at the JAX tool's rounding and the emitted rows frame
for frame (``ablation_parity.first_difference``), but for BoostTrack at
cadence 2, whose stated tolerance and traced cause are below.
"""

import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from ablation_parity import both, first_difference

# BoostTrack at cadence 2 (ROADMAP queue 3): the two packages emit the
# same rows up to frame 46. Frame 47 carries no embeddings, so with ReID
# on every detection-track pair takes the 0.5 baseline similarity and
# passes the fused cost's gate (the bypass tests/test_accuracy_ablation.py
# pins): 1774 of the 1848 valid pairs cost exactly -0.5. The other costs
# differ in their last bits (up to 2.4e-7) between XLA, which fuses
# multiplies and adds, and PyTorch; both packages' exact JV solvers give
# the same assignment on either cost matrix, and the two matrices give
# assignments that differ in two rows. From there the runs part: measured
# at 150 frames, HOTA 69.40 against JAX's 70.70, MOTA 68.03 / 69.03, IDF1
# 78.52 / 80.21, DetA 68.38 / 68.77, AssA 70.50 / 72.74, IDSW 191 / 176,
# MT 36 / 38, ML 8 / 11.
BOOST_CADENCE2_FIRST = 47
BOOST_CADENCE2_ATOL = {"HOTA": 2.5, "MOTA": 2.5, "IDF1": 2.5, "DetA": 2.5,
                       "AssA": 2.5, "IDSW": 20, "MT": 3, "ML": 3,
                       "FP": 80, "FN": 30}


@pytest.mark.parametrize("tracker,cadence", [("botsort", 8),
                                             ("deepocsort", 8)])
def test_deployed_cadence_point_equals_the_jax_tools(tracker, cadence,
                                                      monkeypatch):
    port, jax, port_out, jax_out = both(monkeypatch, [tracker],
                                        emb_cadence=cadence)
    assert port == jax
    assert first_difference(port_out[tracker], jax_out[tracker]) is None


def test_boosttrack_cadence_2_parts_from_jax_at_its_first_tie_plateau(
        monkeypatch):
    port, jax, port_out, jax_out = both(monkeypatch, ["boosttrack"],
                                        emb_cadence=2)
    first = first_difference(port_out["boosttrack"], jax_out["boosttrack"])
    assert first == BOOST_CADENCE2_FIRST
    assert first % 2  # a frame without embeddings
    got, want = port["boosttrack"], jax["boosttrack"]
    for key, atol in BOOST_CADENCE2_ATOL.items():
        assert got[key] == pytest.approx(want[key], abs=atol), key


def test_replica_mode_equals_the_jax_tools(monkeypatch):
    """The replica comparison's scene: no camera pan, no injected warps."""
    port, jax, port_out, jax_out = both(monkeypatch, ["bytetrack"],
                                        pan_amp=(0, 0), use_warps=False)
    assert port == jax
    assert first_difference(port_out["bytetrack"],
                            jax_out["bytetrack"]) is None
