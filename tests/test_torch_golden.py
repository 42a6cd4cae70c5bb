"""Port parity end to end: the port's CLI, on the CPU with the exact JV
solver, writes the ByteTrack and BoT-SORT goldens that the JAX package
pins (tests/test_golden.py) byte for byte, from detections its own
loader parses as the JAX package's does."""

from pathlib import Path

import numpy as np
import pytest

from motcpp_tpu_torch.cli import main
from motcpp_tpu_torch.data import MOT17Dataset

import torch_threads  # noqa: F401  (torch at one thread)

ROOT = Path(__file__).resolve().parent
MOT_MINI = ROOT.parent / "assets" / "MOT17-mini" / "train"

SETS = {
    "golden": (),
    "golden_long": ("--no-ablation", "--limit-frames", "150"),
}


def check_goldens(tracker, which, out):
    rc = main([str(MOT_MINI), str(out), tracker, "--max-dets", "128",
               "--max-tracks", "128", "--cpu", *SETS[which]])
    assert rc == 0
    golden = sorted((ROOT / which / tracker).glob("*.txt"))
    assert len(golden) == 2
    for gf in golden:
        assert (out / gf.name).read_text() == gf.read_text(), gf.name


@pytest.mark.parametrize("which", sorted(SETS))
def test_port_cli_writes_bytetrack_goldens(which, tmp_path):
    check_goldens("bytetrack", which, tmp_path)


@pytest.mark.parametrize("which", sorted(SETS))
def test_port_cli_writes_botsort_goldens(which, tmp_path):
    check_goldens("botsort", which, tmp_path)


@pytest.fixture
def jax_native_parser(monkeypatch, tmp_path):
    """The JAX package's native parser, built into a library of this test
    and loaded from it. ``native_io`` builds ``native/libmotcpp_io.so``
    in place at first use and keeps a failed load for the rest of the
    process, so under several workers one process can open another's
    half-written library and then parse with the Python fallback, which
    rounds otherwise. A library no other process writes is complete once
    its build returns."""
    from motcpp_tpu.utils import native_io

    monkeypatch.setattr(native_io, "_SO", tmp_path / "libmotcpp_io.so")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_tried", False)
    assert native_io.available(), "the JAX package's native parser did not build"


def test_port_loader_parses_as_the_jax_package(jax_native_parser):
    """Detections identical to the JAX package's loader, to the bit: its
    native parser (native/motcpp_io.cpp) reads float32 values and adds
    x + w in float32, which a float64 sum rounded once can miss by an ulp
    (MOT17-04 frame 4 then wrote a different BoT-SORT row)."""
    from motcpp_tpu.data import MOT17Dataset as JaxDataset

    port = MOT17Dataset(MOT_MINI).sequences
    jax_side = JaxDataset(MOT_MINI).sequences
    assert [s.name for s in port] == [s.name for s in jax_side]
    for ps, js in zip(port, jax_side):
        got = MOT17Dataset.load_detections(ps.det_path)
        want = JaxDataset.load_detections(js.det_path)
        assert sorted(got) == sorted(want)
        for f in want:
            assert got[f].dtype == np.float32
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{ps.name} {f}")


def test_cli_reads_embedding_files_and_images(tmp_path):
    """Pre-generated embeddings load as the JAX package loads them and
    reach the tracker with their frame's detections; --images hands the
    tracker the real frame; reid_weights turns on live ReID for BoT-SORT
    only."""
    import shutil

    from motcpp_tpu.data import MOT17Dataset as JaxDataset
    from motcpp_tpu_torch.cli import build_tracker, run_sequence

    root = tmp_path / "det_emb"
    (root / "dets").mkdir(parents=True)
    (root / "embs").mkdir()
    seq_dir = MOT_MINI / "MOT17-02-FRCNN"
    shutil.copy(seq_dir / "det" / "det.txt", root / "dets" / "MOT17-02.txt")
    n_rows = len((seq_dir / "det" / "det.txt").read_text().split())
    embs = np.random.default_rng(0).normal(size=(n_rows, 8)).astype(np.float32)
    np.savetxt(root / "embs" / "MOT17-02.txt", embs, fmt="%.6f")

    ds = MOT17Dataset(MOT_MINI, str(root), "det")
    seq = next(s for s in ds.sequences if s.name == "MOT17-02-FRCNN")
    dets = ds.load_detections(seq.det_path)
    got = ds.load_embeddings(ds.emb_path_for(seq.name), dets)
    jds = JaxDataset(MOT_MINI, str(root), "det")
    want = jds.load_embeddings(jds.emb_path_for(seq.name), dets)
    assert sorted(got) == sorted(want) and len(got) > 2
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])

    class Recorder:
        def __init__(self):
            self.calls = []

        def update(self, d, img, e):
            self.calls.append((d, img, e))
            return np.zeros((0, 8), np.float32)

    rec = Recorder()
    run_sequence(rec, seq, dets, tmp_path / "out.txt", got, use_images=True,
                 no_ablation=True, limit_frames=2)
    assert len(rec.calls) == 2
    for (d, img, e), f in zip(rec.calls, sorted(dets)):
        np.testing.assert_array_equal(e, got[f])
        assert e.shape[0] == d.shape[0]
        assert img.shape == (1080, 1920, 3) and img.any()

    weights = str(ROOT / "fixtures" / "osnet_x0_25_converted.npz")
    assert build_tracker("botsort", reid_weights=weights,
                         device="cpu").reid_weights == weights
    assert not hasattr(build_tracker("bytetrack", reid_weights=weights,
                                     device="cpu"), "reid_weights")
