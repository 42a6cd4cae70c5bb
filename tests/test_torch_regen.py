"""The port's golden regenerators (``motcpp_tpu_torch/scripts/
regen_golden.py``, ``regen_golden_cmc.py``, ``regen_golden_reid.py``),
with their output roots pointed at ``tmp_path``, reproduce the committed
``tests/golden``, ``tests/golden_long``, ``tests/golden_cmc`` and
``tests/golden_reid`` files byte for byte on the CPU, and say so; where a
set differs they name the first file and line. Every test also checks
that nothing under ``tests/`` was written. The other trackers' golden
sets are held through the port's CLI by their own test files.
"""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu_torch.scripts import (
    regen_golden,
    regen_golden_cmc,
    regen_golden_reid,
)

TESTS = Path(__file__).resolve().parent


def tree_hash(root):
    """A hash of every file under ``root`` (names and bytes), compiled
    Python left out."""
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + b"\0")
            h.update(p.read_bytes())
    return h.hexdigest()


@pytest.fixture
def tests_untouched():
    before = tree_hash(TESTS)
    yield
    assert tree_hash(TESTS) == before, "a regenerator wrote under tests/"


@pytest.mark.parametrize("tracker", ["sort", "bytetrack"])
def test_regen_golden_reproduces_both_sets(tracker, tmp_path, monkeypatch,
                                           capsys, tests_untouched):
    monkeypatch.setattr(regen_golden, "BUILD", tmp_path)
    assert regen_golden.main([tracker, "--cpu"]) == 0
    verdicts = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("regenerated ")]
    assert verdicts == [
        f"regenerated {tmp_path / kind / tracker}: equals tests/{kind}/"
        f"{tracker} byte for byte" for kind in regen_golden.SETS]
    for kind in regen_golden.SETS:
        want = sorted((TESTS / kind / tracker).glob("*.txt"))
        assert len(want) == 2
        for w in want:
            assert (tmp_path / kind / tracker / w.name).read_bytes() == \
                w.read_bytes()


def test_regen_golden_names_the_first_difference(tmp_path, tests_untouched):
    got = tmp_path / "bytetrack"
    shutil.copytree(TESTS / "golden" / "bytetrack", got)
    assert regen_golden.first_difference(got, TESTS / "golden" /
                                         "bytetrack") is None
    path = got / "MOT17-04-FRCNN.txt"
    lines = path.read_text().splitlines(keepends=True)
    lines[2] = lines[2].replace(",", ";", 1)
    path.write_text("".join(lines))
    assert regen_golden.verdict(got, TESTS / "golden" / "bytetrack") == (
        "differs from tests/golden/bytetrack at MOT17-04-FRCNN.txt:3")
    assert regen_golden.verdict(path, TESTS / "golden" / "bytetrack" /
                                path.name) == (
        "differs from tests/golden/bytetrack/MOT17-04-FRCNN.txt at line 3")
    path.unlink()
    assert regen_golden.first_difference(
        got, TESTS / "golden" / "bytetrack") == (
        f"MOT17-04-FRCNN.txt (only in {TESTS / 'golden' / 'bytetrack'})")
    with pytest.raises(ValueError, match="unknown golden set"):
        regen_golden.write_set("sort", "golden_short", tmp_path, "cpu")


@pytest.mark.parametrize("name", ["botsort_sofjax", "strongsort_ecc"])
def test_regen_golden_cmc_reproduces_the_committed_rows(
        name, tmp_path, monkeypatch, capsys, tests_untouched):
    if dict((n, cv2) for n, _, _, cv2 in regen_golden_cmc.RUNS)[name]:
        pytest.importorskip("cv2")
    monkeypatch.setattr(regen_golden_cmc, "GOLDEN", tmp_path)
    assert regen_golden_cmc.main([name, "--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"regenerated {name}: ")
    assert out.endswith(f"; equals tests/golden_cmc/{name}.txt byte for "
                        "byte\n")
    assert (tmp_path / f"{name}.txt").read_bytes() == (
        TESTS / "golden_cmc" / f"{name}.txt").read_bytes()


def test_regen_golden_cmc_does_not_run_what_needs_cv2_without_it(
        tmp_path, monkeypatch, capsys, tests_untouched):
    monkeypatch.setattr(regen_golden_cmc, "GOLDEN", tmp_path)
    monkeypatch.setattr(regen_golden_cmc, "has_cv2", lambda: False)
    assert regen_golden_cmc.main(["strongsort_ecc", "--cpu"]) == 0
    assert "strongsort_ecc: not run" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


def test_regen_golden_reid_reproduces_the_committed_files(
        tmp_path, monkeypatch, capsys, tests_untouched):
    monkeypatch.setattr(regen_golden_reid, "GOLDEN", tmp_path)
    assert regen_golden_reid.main(["--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("forward_fingerprint.json: equals tests/golden_reid/"
                      "forward_fingerprint.json byte for byte")
    for name, line in zip(regen_golden_reid.TRACKERS, out[1:]):
        n = len(json.loads((TESTS / "golden_reid" /
                            f"{name}_MOT17-02.json").read_text()))
        assert line == (f"{name}: {n} golden rows; {name}_MOT17-02.json: "
                        f"equals tests/golden_reid/{name}_MOT17-02.json byte "
                        "for byte")
    want = sorted(p.name for p in (TESTS / "golden_reid").iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == want
    for name in want:
        assert (tmp_path / name).read_bytes() == (
            TESTS / "golden_reid" / name).read_bytes()


def test_regen_golden_reid_raises_where_no_frame_can_be_read(monkeypatch):
    monkeypatch.setattr("motcpp_tpu_torch.data.mot17.imread", lambda p: None)
    with pytest.raises(RuntimeError, match="cv2 or PIL"):
        regen_golden_reid.load_frames_and_dets()
