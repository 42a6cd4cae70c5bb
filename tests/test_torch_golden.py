"""Port parity end to end: the port's CLI, on the CPU with the exact JV
solver, writes the ByteTrack goldens that the JAX package pins
(tests/test_golden.py) byte for byte."""

from pathlib import Path

import pytest

from motcpp_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parent
MOT_MINI = ROOT.parent / "assets" / "MOT17-mini" / "train"

SETS = {
    "golden": ((), ROOT / "golden" / "bytetrack"),
    "golden_long": (("--no-ablation", "--limit-frames", "150"),
                    ROOT / "golden_long" / "bytetrack"),
}


@pytest.mark.parametrize("which", sorted(SETS))
def test_port_cli_writes_bytetrack_goldens(which, tmp_path):
    extra, golden_dir = SETS[which]
    rc = main([str(MOT_MINI), str(tmp_path), "bytetrack", "--max-dets", "128",
               "--max-tracks", "128", "--cpu", *extra])
    assert rc == 0
    golden = sorted(golden_dir.glob("*.txt"))
    assert len(golden) == 2
    for gf in golden:
        assert (tmp_path / gf.name).read_text() == gf.read_text(), gf.name
