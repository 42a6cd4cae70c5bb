"""Port parity end to end: the port's CLI, on the CPU with the exact JV
solver, writes the ByteTrack and BoT-SORT goldens that the JAX package
pins (tests/test_golden.py) byte for byte, from detections its own
loader parses as the JAX package's does."""

import ast
from pathlib import Path

import numpy as np
import pytest

from motcpp_tpu_torch.cli import main
from motcpp_tpu_torch.data import MOT17Dataset

import torch_threads  # noqa: F401  (torch at one thread)
from jax_cases import jax_native_parser  # noqa: F401  (a fixture)

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


def test_cli_reads_embedding_files_and_images(jax_native_parser, tmp_path):
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


# the JAX package's modules and names whose use reaches
# motcpp_tpu.utils.native_io._load
JAX_NATIVE_MODULES = ("motcpp_tpu.cli", "motcpp_tpu.utils.native_io",
                      "motcpp_tpu.data.mot17", "motcpp_tpu.data.mot_format")
JAX_NATIVE_NAMES = ("MOT17Dataset", "write_mot_results")


def _native_bindings(nodes):
    """Names bound by the imports among ``nodes`` whose use reaches the
    JAX package's native IO."""
    names = set()
    for node in nodes:
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if (node.module in JAX_NATIVE_MODULES
                        or f"{node.module}.{a.name}" in JAX_NATIVE_MODULES
                        or (node.module == "motcpp_tpu.data"
                            and a.name in JAX_NATIVE_NAMES)):
                    names.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            names.update(a.asname or a.name for a in node.names
                         if a.name in JAX_NATIVE_MODULES)
    return names


def functions_reaching_jax_native_io(path):
    """{function name: its argument names} for every module-level function
    of ``path`` that imports, or uses a module-level import of, what
    reaches the JAX package's native IO."""
    tree = ast.parse(Path(path).read_text())
    top = _native_bindings(tree.body)
    found = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        inner = list(ast.walk(fn))
        used = {n.id for n in inner if isinstance(n, ast.Name)}
        if _native_bindings(inner) or used & top:
            found[fn.name] = {a.arg for a in fn.args.args}
    return found


def test_port_tests_reach_the_jax_native_io_only_through_the_fixture():
    """Every port test that reads or writes through the JAX package's
    dataset, writer or CLI asks for ``jax_native_parser``, so none builds
    or loads ``native/libmotcpp_io.so`` in place: that build races the
    JAX package's own tests under several workers, and a worker that
    loses it parses with the Python fallback for the rest of its run
    (ROADMAP queue 3)."""
    reaching, missing = [], []
    for path in sorted(ROOT.glob("test_torch_*.py")):
        for name, args in functions_reaching_jax_native_io(path).items():
            reaching.append(f"{path.name}::{name}")
            if "jax_native_parser" not in args:
                missing.append(f"{path.name}::{name}")
    assert "test_torch_golden.py::test_cli_reads_embedding_files_and_images" \
        in reaching
    assert not missing, f"reach the JAX package's native IO without the " \
        f"jax_native_parser fixture: {missing}"


def test_jax_native_parser_loads_a_library_of_its_own(jax_native_parser,
                                                      tmp_path):
    """The fixture's library is the test's own, never the in-place
    ``native/libmotcpp_io.so``, and the JAX package's loader reads
    through it."""
    native_io = jax_native_parser
    own = tmp_path / "libmotcpp_io.so"
    assert native_io._SO == own != native_io._NATIVE_DIR / "libmotcpp_io.so"
    assert Path(native_io._lib._name) == own and own.exists()
    from motcpp_tpu.data import MOT17Dataset as JaxDataset

    det = MOT_MINI / "MOT17-02-FRCNN" / "det" / "det.txt"
    assert JaxDataset.load_detections(det)
    assert native_io._lib is not None and native_io._SO == own
