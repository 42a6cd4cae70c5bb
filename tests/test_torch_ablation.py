"""Port parity: the ablation accuracy scoreboard of motcpp_tpu_torch
(``motcpp_tpu_torch/scripts/ablation_benchmark.py``) against the JAX
package's ``scripts/ablation_benchmark.py``, on the CPU: the motion-only
rows, the tool's command line, and the plain auction against the exact JV.

Each SCOREBOARD row without embeddings runs in both packages at 150
frames (the scene's minimum) with each wrapper's default solver, the
exact JV, and every metric must be equal at the JAX tool's rounding, the
emitted rows frame for frame too (``ablation_parity.first_difference``).
The embedding rows are in ``tests/test_torch_ablation_reid.py``, the
cadence probes and the replica mode in
``tests/test_torch_ablation_cadence.py`` and the budget probes in
``tests/test_torch_ablation_budget.py``: under ``--dist loadfile`` one
file is one worker's load. The 600-frame run against the committed table
is ``test_port_scoreboard_reproduces_the_committed_table``, marked slow
as the JAX package's is.
"""

import json

import numpy as np
import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from ablation_parity import FRAMES, ROOT, both, first_difference, jax_tool
from motcpp_tpu_torch.scripts import ablation_benchmark as port_tool

MOTION_ROWS = [n for n, spec in port_tool.SCOREBOARD.items()
               if not spec["embs"]]
_port_rows = {}


def test_scoreboard_is_the_jax_tools():
    """The same eleven rows at the same configurations, in the same
    order; the embedding rows are the rest."""
    assert port_tool.SCOREBOARD == jax_tool.SCOREBOARD
    assert list(port_tool.SCOREBOARD) == list(jax_tool.SCOREBOARD)
    assert len(port_tool.SCOREBOARD) == 11
    assert MOTION_ROWS == ["sort", "bytetrack", "ocsort", "ucmctrack",
                           "boosttrack-noreid", "hybridsort-noreid"]


@pytest.mark.parametrize("tracker", MOTION_ROWS)
def test_motion_row_equals_the_jax_tools(tracker, monkeypatch):
    port, jax, port_out, jax_out = both(monkeypatch, [tracker])
    _port_rows[tracker] = port[tracker]
    assert port == jax
    model = port_tool.SCOREBOARD[tracker].get("model", tracker)
    assert first_difference(port_out[model], jax_out[model]) is None


@pytest.mark.parametrize("tracker", ["bytetrack"])
def test_plain_auction_row_is_within_one_hota_of_jv(tracker):
    """The JAX package's auction-against-JV bar
    (tests/test_accuracy_synthetic.py::test_auction_accuracy_parity_with_jv)
    on the port's rows; BoostTrack's is in the embedding rows' file."""
    jv = _port_rows.get(tracker) or port_tool.run_scoreboard(
        FRAMES, [tracker], progress=len, device="cpu")[tracker]
    auction = port_tool.run_scoreboard(FRAMES, [tracker], progress=len,
                                       device="cpu", lap_impl="auction")
    assert auction[tracker]["HOTA"] == pytest.approx(jv["HOTA"], abs=1.0)


def test_main_runs_on_the_cpu_and_writes_only_its_build_table(
        capsys, monkeypatch, tmp_path):
    """``--cpu --frames 150 --trackers bytetrack`` exits 0 and prints the
    JAX tool's progress line; ``--write`` writes the table where TABLE
    points (``motcpp_tpu_torch/_build/``), and no table under tests/."""
    assert port_tool.TABLE.parent == ROOT / "motcpp_tpu_torch" / "_build"
    committed = {p: p.read_bytes()
                 for p in (ROOT / "tests").glob("accuracy_*.json")}
    table = tmp_path / "accuracy_ablation_torch.json"
    monkeypatch.setattr(port_tool, "TABLE", table)
    argv = ["--cpu", "--frames", str(FRAMES), "--trackers", "bytetrack"]
    assert port_tool.main(argv + ["--write"]) == 0
    lines = capsys.readouterr().out.splitlines()
    written = json.loads(table.read_text())
    want = []
    jax = jax_tool.run_scoreboard(FRAMES, ["bytetrack"], progress=want.append)
    # the line without its seconds, which the host's clock sets
    assert [ln.rsplit("(", 1)[0] for ln in lines[:1]] == [
        ln.rsplit("(", 1)[0] for ln in want]
    assert lines[1] == f"wrote {table}"
    assert written == json.loads(json.dumps(jax))
    assert {p: p.read_bytes() for p in committed} == committed


def test_main_fails_fast_on_an_unknown_tracker(monkeypatch):
    def no_scene(*args, **kwargs):
        raise AssertionError("the scene was built")

    monkeypatch.setattr("motcpp_tpu_torch.data.synthetic.ablation_scene",
                        no_scene)
    with pytest.raises(SystemExit, match="unknown tracker"):
        port_tool.main(["--cpu", "--trackers", "bytetrack", "nosuch"])


@pytest.mark.parametrize("probe", [["--emb-cadence", "2"],
                                   ["--emb-budget", "0.6"]])
def test_write_refuses_a_probe(probe, monkeypatch, tmp_path):
    monkeypatch.setattr(port_tool, "TABLE", tmp_path / "t.json")
    with pytest.raises(SystemExit, match="PLAIN scoreboard"):
        port_tool.main(["--cpu", "--write"] + probe)
    assert not (tmp_path / "t.json").exists()


def test_lap_takes_the_three_solvers_only():
    with pytest.raises(SystemExit):
        port_tool.main(["--cpu", "--lap", "lapjv"])


def test_fewer_than_150_frames_raise_in_both_packages():
    with pytest.raises(ValueError):
        port_tool.run_scoreboard(100, ["sort"], progress=len, device="cpu")
    with pytest.raises(ValueError):
        jax_tool.run_scoreboard(100, ["sort"], progress=len)


def test_budget_select_keeps_the_ceiling_by_confidence():
    """The confidence policy keeps ceil(f * n) of the highest
    confidences, at least one."""
    d = np.zeros((5, 6), np.float32)
    d[:, 4] = [0.3, 0.9, 0.5, 0.8, 0.1]
    sel = port_tool.budget_select(d, None, 1, 0.5, "conf", "cpu")
    assert sel.tolist() == [False, True, True, True, False]
    sel = port_tool.budget_select(d, None, 1, 0.01, "conf", "cpu")
    assert sel.tolist() == [False, True, False, False, False]


@pytest.mark.slow
def test_port_scoreboard_reproduces_the_committed_table():
    """The port's 600-frame scoreboard on the CPU, each wrapper's exact
    JV, against tests/accuracy_ablation.json at the JAX package's
    tolerance (tests/test_accuracy_ablation.py::
    test_committed_scoreboard_reproduces). About four minutes, so slow, as
    the JAX package's is."""
    table = json.loads((ROOT / "tests" / "accuracy_ablation.json")
                       .read_text())
    got = port_tool.run_scoreboard(600, list(table), progress=len,
                                   device="cpu")
    for name, want in table.items():
        for key in ("HOTA", "MOTA", "IDF1", "DetA", "AssA"):
            assert got[name][key] == pytest.approx(want[key], abs=0.5), (
                name, key)
