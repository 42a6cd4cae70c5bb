"""Port parity: the ablation scoreboard's embedding rows
(``motcpp_tpu_torch/scripts/ablation_benchmark.py``) against the JAX
package's ``scripts/ablation_benchmark.py``, on the CPU, at 150 frames with
the scene's own embeddings and each wrapper's exact JV: every metric equal
at the JAX tool's rounding and the emitted rows frame for frame
(``ablation_parity.first_difference``). Beside them BoostTrack's plain
auction against its JV row, and the JAX package's pin of BoostTrack's
ReID gate bypass run against the port.
"""

import functools
import types

import pytest

import motcpp_tpu_torch
import test_accuracy_ablation
import torch_threads  # noqa: F401  (torch at one thread)
from ablation_parity import FRAMES, both, first_difference
from jax_cases import jax_cases, run_jax_case
from motcpp_tpu_torch.scripts import ablation_benchmark as port_tool

EMBEDDING_ROWS = [n for n, spec in port_tool.SCOREBOARD.items()
                  if spec["embs"]]
_port_rows = {}


@pytest.mark.parametrize("tracker", EMBEDDING_ROWS)
def test_embedding_row_equals_the_jax_tools(tracker, monkeypatch):
    port, jax, port_out, jax_out = both(monkeypatch, [tracker])
    _port_rows[tracker] = port[tracker]
    assert port == jax
    assert first_difference(port_out[tracker], jax_out[tracker]) is None


@pytest.mark.parametrize("tracker", ["boosttrack"])
def test_plain_auction_row_is_within_one_hota_of_jv(tracker):
    """The JAX package's auction-against-JV bar
    (tests/test_accuracy_synthetic.py::test_auction_accuracy_parity_with_jv)
    on the port's rows."""
    jv = _port_rows.get(tracker) or port_tool.run_scoreboard(
        FRAMES, [tracker], progress=len, device="cpu")[tracker]
    auction = port_tool.run_scoreboard(FRAMES, [tracker], progress=len,
                                       device="cpu", lap_impl="auction")
    assert auction[tracker]["HOTA"] == pytest.approx(jv["HOTA"], abs=1.0)


@pytest.mark.parametrize("case,name,kwargs", jax_cases(
    test_accuracy_ablation, ["test_boosttrack_reid_gate_bypass"]))
def test_jax_gate_bypass_pin_passes_against_the_port(case, name, kwargs,
                                                     monkeypatch):
    port = types.SimpleNamespace(create_tracker=functools.partial(
        motcpp_tpu_torch.create_tracker, device="cpu"))
    run_jax_case(test_accuracy_ablation, name, kwargs, monkeypatch,
                 {"motcpp_tpu": port})
