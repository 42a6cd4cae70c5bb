"""Port parity: the host utilities and small public functions of
motcpp_tpu_torch against the JAX package's, on the CPU.

The native IO library (built by g++ into the port's build directory)
parses the MOT17-mini files into the Python parser's arrays and writes
the Python writer's bytes; the dataset's queries and frames, the
profiling helpers, ``ReIDBackend.warmup``, the OSNet weight converters,
the matching and assignment helpers, the deterministic scenes and the
visualization helpers equal the JAX package's on the same inputs (the
JAX test cases run against the port where their imports can be
redirected, and the outputs are compared where they cannot).
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motcpp_tpu.data.synthetic as jax_synthetic
import motcpp_tpu.utils.visualization as jax_vis
import test_aux
import test_data
import test_lap
import torch_threads  # noqa: F401  (torch at one thread)
from jax_cases import jax_cases, jax_native_parser, run_jax_case  # noqa: F401
from motcpp_tpu.ops import lap as jax_lap
from motcpp_tpu.ops import matching as jax_matching
from motcpp_tpu_torch.data import mot17, mot_format, synthetic
from motcpp_tpu_torch.models import base as port_base
from motcpp_tpu_torch.ops import lap, matching
from motcpp_tpu_torch.utils import native_io, profiling, visualization

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MOT_MINI = ROOT / "assets" / "MOT17-mini" / "train"
MOT_FILES = sorted(MOT_MINI.glob("*/det/det.txt")) + sorted(
    MOT_MINI.glob("*/gt/gt.txt"))
FIXTURE = HERE / "fixtures" / "osnet_x0_25_converted.npz"


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# 5. native IO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", MOT_FILES,
                         ids=lambda p: str(p.relative_to(MOT_MINI)))
def test_native_parser_equals_the_python_parser(path):
    assert native_io.available()
    got = native_io.parse_detections(path)
    want = mot17._parse_det_text(path)
    assert len(got) == len(want) > 0
    assert [f for f, _ in got] == [f for f, _ in want]
    g = np.asarray([r for _, r in got], np.float32)
    w = np.asarray([r for _, r in want], np.float32)
    assert g.tobytes() == w.tobytes()
    raw = native_io.parse_floats(path)
    assert raw.dtype == np.float32 and raw.shape[0] == len(got)


def test_dataset_loads_through_the_native_parser(monkeypatch):
    """load_detections reads through the native library and equals the
    Python fallback's arrays."""
    seq = mot17.MOT17Dataset(MOT_MINI).sequences[0]
    native = mot17.MOT17Dataset.load_detections(seq.det_path)
    monkeypatch.setattr(native_io, "parse_detections",
                        lambda p: (_ for _ in ()).throw(RuntimeError()))
    python = mot17.MOT17Dataset.load_detections(seq.det_path)
    assert sorted(native) == sorted(python)
    for f in native:
        assert native[f].tobytes() == python[f].tobytes()


def test_embeddings_load_through_the_native_parser(tmp_path, monkeypatch):
    dets = {1: np.zeros((2, 6), np.float32), 3: np.zeros((1, 6), np.float32)}
    embs = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    path = tmp_path / "e.txt"
    np.savetxt(path, embs, fmt="%.7f")
    got = mot17.MOT17Dataset.load_embeddings(path, dets)
    np.testing.assert_array_equal(native_io.parse_embeddings(path),
                                  np.loadtxt(path, dtype=np.float32, ndmin=2))
    monkeypatch.setattr(native_io, "parse_embeddings",
                        lambda p: (_ for _ in ()).throw(RuntimeError()))
    want = mot17.MOT17Dataset.load_embeddings(path, dets)
    assert sorted(got) == sorted(want) == [1, 3]
    for f in got:
        assert got[f].tobytes() == want[f].tobytes()


def test_native_writer_writes_the_python_writers_bytes(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    tracks = np.concatenate([rng.uniform(-50, 1900, (40, 4)),
                             rng.integers(1, 99, (40, 1)),
                             rng.uniform(0, 1, (40, 1)),
                             np.zeros((40, 2))], 1).astype(np.float32)
    tracks[:, 2:4] += tracks[:, :2] * 0.0 + 80.0
    rows = np.concatenate([mot_format.convert_to_mot_format(tracks[i::4], i)
                           for i in range(1, 4)])
    native = tmp_path / "a" / "native.txt"
    mot_format.write_mot_results(native, rows)
    monkeypatch.setattr(native_io, "write_mot", lambda *a: False)
    python = tmp_path / "b" / "python.txt"
    mot_format.write_mot_results(python, rows)
    assert native.read_bytes() == python.read_bytes()
    assert len(native.read_text().splitlines()) == rows.shape[0]


def test_native_library_builds_under_the_port_only():
    """The build lands in the port's build directory under a hash-keyed
    name and writes nothing into native/."""
    before = {p.name: p.stat().st_mtime_ns
              for p in (ROOT / "native").iterdir()}
    path = native_io.build()
    assert path.parent == ROOT / "motcpp_tpu_torch" / "_build"
    assert path.name.startswith("libmotcpp_io_") and path.exists()
    assert {p.name: p.stat().st_mtime_ns
            for p in (ROOT / "native").iterdir()} == before


# ---------------------------------------------------------------------------
# 6. the dataset's queries and frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,name,kwargs", jax_cases(
    test_data, ["test_mot17_mini_indexing"]))
def test_jax_dataset_cases_pass_against_the_port(case, name, kwargs,
                                                 monkeypatch):
    run_jax_case(test_data, name, kwargs, monkeypatch,
                 {"MOT17Dataset": mot17.MOT17Dataset})


def test_get_frame_equals_the_jax_package(jax_native_parser):
    from motcpp_tpu.data import MOT17Dataset as JaxDataset

    port, jax_ds = mot17.MOT17Dataset(MOT_MINI), JaxDataset(MOT_MINI)
    assert port.sequence_names() == jax_ds.sequence_names()
    with pytest.raises(KeyError):
        port.get_sequence_info("MOT17-99-FRCNN")
    for name in port.sequence_names():
        ps, js = port.get_sequence_info(name), jax_ds.get_sequence_info(name)
        dets = port.load_detections(ps.det_path)
        embs = {f: np.full((d.shape[0], 3), f, np.float32)
                for f, d in dets.items()}
        for f in (1, 2, ps.frame_ids[-1] + 1, 10**6):
            got = port.get_frame(ps, f, dets, embs)
            want = jax_ds.get_frame(js, f, dets, embs)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    assert g.dtype == w.dtype and np.array_equal(g, w)
        assert port.get_frame(ps, 1, dets, embs)[0] is not None


# ---------------------------------------------------------------------------
# 7. profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,name,kwargs", jax_cases(
    test_aux, ["test_frame_timer"]))
def test_jax_profiling_cases_pass_against_the_port(case, name, kwargs,
                                                   monkeypatch):
    run_jax_case(test_aux, name, kwargs, monkeypatch,
                 modules={"motcpp_tpu.utils.profiling": profiling})


def test_trace_exports_a_chrome_trace_of_the_block(tmp_path):
    """On the CPU the trace records the host's operators; the card's
    kernels are recorded on the card (tests/test_torch_cuda.py)."""
    x = torch.ones((16, 16))
    with profiling.trace(tmp_path / "t", device="cpu") as logdir:
        (x @ x).sum()
    files = list(Path(logdir).glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "aten::mm" in names


# ---------------------------------------------------------------------------
# 8. ReIDBackend.warmup
# ---------------------------------------------------------------------------

def test_reid_warmup_is_the_jax_packages_forward(monkeypatch):
    """warmup() runs get_features on the JAX package's seeded batch of two
    boxes of a 256x256 image, and the port's unfolded forward embeds them
    as the JAX backend's does (within the 1e-3 of the forward
    fingerprint, tests/test_torch_appearance.py)."""
    from motcpp_tpu.appearance.reid import ReIDBackend as JaxBackend
    from motcpp_tpu_torch.appearance.reid import ReIDBackend

    calls, feats = {}, {}

    def spy(key, fn):
        def wrapped(xyxys, img):
            calls[key] = (np.asarray(xyxys).copy(), np.asarray(img).copy())
            feats[key] = fn(xyxys, img)
            return feats[key]
        return wrapped

    for key, b in (("jax", JaxBackend(weights=str(FIXTURE))),
                   ("port", ReIDBackend(weights=str(FIXTURE), device="cpu"))):
        monkeypatch.setattr(b, "get_features", spy(key, b.get_features))
        assert b.warmup() is None
    for g, w in zip(calls["port"], calls["jax"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert feats["port"].shape == (2, 512)
    np.testing.assert_allclose(feats["port"], feats["jax"], rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# 9. OSNet weight converters
# ---------------------------------------------------------------------------

def test_convert_torch_state_dict_and_npz_equal_the_jax_package(tmp_path):
    from motcpp_tpu.appearance import osnet as jax_osnet
    from motcpp_tpu_torch.appearance import osnet

    model = osnet.init_params(osnet.osnet_x0_25(feature_dim=16), seed=3)
    sd = model.state_dict()
    got = osnet.convert_torch_state_dict(sd)
    want = jax_osnet.convert_torch_state_dict(sd)
    flat_g, flat_w = osnet._flat_paths(got), jax_osnet._flat_paths(want)
    assert sorted(flat_g) == sorted(flat_w)
    for k, w in flat_w.items():
        g, w = flat_g[k], np.asarray(w)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
        assert g.tobytes() == w.tobytes(), k
    # the inverse of state_dict_from_flax, tensor for tensor
    back = osnet.state_dict_from_flax(got)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k

    osnet.save_npz_variables(tmp_path / "port.npz", got)
    jax_osnet.save_npz_variables(tmp_path / "jax.npz", want)
    with np.load(tmp_path / "port.npz") as p, \
            np.load(tmp_path / "jax.npz") as j:
        assert p.files == j.files
        for k in j.files:
            assert p[k].dtype == j[k].dtype and p[k].tobytes() == \
                j[k].tobytes(), k
    for loader in (osnet.load_npz_variables, jax_osnet.load_npz_variables):
        flat = osnet._flat_paths(loader(tmp_path / "port.npz"))
        assert sorted(flat) == sorted(flat_g)
        for k, v in flat.items():
            assert np.asarray(v).tobytes() == flat_g[k].tobytes(), k


# ---------------------------------------------------------------------------
# 10. matching and assignment helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,name,kwargs", jax_cases(test_lap, [
    "test_empty_threshold_cases", "test_single_match",
    "test_match_above_threshold_rejected", "test_diagonal_optimal",
    "test_rectangular_both_ways", "test_optimality_beats_greedy",
    "test_matches_reference_padding_semantics", "test_negative_costs",
    "test_inf_entries_never_matched"]))
def test_jax_lap_cases_pass_against_the_port(case, name, kwargs, monkeypatch):
    run_jax_case(test_lap, name, kwargs, monkeypatch, {
        "linear_assignment": functools.partial(matching.linear_assignment,
                                               device="cpu")},
        rng=np.random.default_rng(42))


def test_linear_assignment_equals_the_jax_package():
    """The host wrapper (exact JV) on tests/test_lap.py's random shapes
    and thresholds, against the JAX package's."""
    rng = np.random.default_rng(42)
    for shape in [(4, 4), (7, 3), (3, 7), (12, 12), (1, 9)]:
        for thresh in (0.3, 0.7, 1.5):
            cost = rng.random(shape, np.float32)
            got = matching.linear_assignment(cost, thresh, device="cpu")
            assert got == jax_matching.linear_assignment(cost, thresh)


def test_masked_and_unmasked_solvers_equal_the_jax_package():
    """tests/test_lap.py's masked, col2row and batch cases: the port's
    linear_assignment_masked, solve_lap_masked and solve_lap (one problem
    and a batch) return the JAX solvers' maps."""
    rng = np.random.default_rng(42)
    R, C = 10, 8
    cost = rng.random((R, C), np.float32)
    rm, cm = np.arange(R) < 5, np.arange(C) < 6
    want = jax_matching.linear_assignment_masked(
        jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm), 0.8)
    got = matching.linear_assignment_masked(
        torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
        0.8)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g, np.asarray(w))
    got = lap.solve_lap_masked(*(torch.from_numpy(a)[None]
                                 for a in (cost, rm, cm)), 0.8)
    for g, w in zip(got, want):
        assert np.array_equal(g[0], np.asarray(w))
    cost = rng.random((6, 9), np.float32)
    for g, w in zip(lap.solve_lap(torch.from_numpy(cost), 0.7),
                    jax_lap.solve_lap(jnp.asarray(cost), 0.7)):
        assert g.shape == w.shape and np.array_equal(g, np.asarray(w))
    costs = rng.random((4, 5, 5), np.float32)
    got = lap.solve_lap(torch.from_numpy(costs), 0.6)
    for b in range(4):
        for g, w in zip(got, jax_lap.solve_lap(jnp.asarray(costs[b]), 0.6)):
            assert np.array_equal(g[b], np.asarray(w))


@pytest.mark.parametrize("name", ["iou_distance", "embedding_distance_cosine",
                                  "embedding_distance_euclidean", "fuse_score",
                                  "fuse_iou", "fuse_motion"])
def test_cost_functions_equal_the_jax_package(name):
    """The inputs of tests/test_matching.py's cases and seeded random
    ones, through both packages: the same values within float32
    rounding (rtol 1e-6), +inf where JAX gives +inf."""
    rng = np.random.default_rng(0)

    def boxes(n):
        xy = rng.uniform(0, 300, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(10, 120, (n, 2))],
                              1).astype(np.float32)

    a, b = boxes(6), boxes(5)
    fa, fb = (rng.normal(size=(n, 8)).astype(np.float32) for n in (6, 5))
    cost = rng.random((6, 5), np.float32)
    gating = rng.uniform(0, 14, (6, 5)).astype(np.float32)
    cases = {
        "iou_distance": [((a, b), {}),
                         ((np.float32([[0, 0, 100, 100]]),) * 2, {})],
        "embedding_distance_cosine": [
            ((fa, fb), {"metric": "cosine"}),
            ((np.float32([[1, 0], [0, 2]]), np.float32([[1, 0], [-1, 0]])),
             {"metric": "cosine"})],
        "embedding_distance_euclidean": [
            ((fa, fb), {"metric": "euclidean"}),
            ((np.float32([[0, 0]]), np.float32([[3, 4]])),
             {"metric": "euclidean"})],
        "fuse_score": [((cost, rng.random(5, np.float32)), {}),
                       ((np.float32([[0.2, 0.5]]), np.float32([0.9, 0.5])),
                        {})],
        "fuse_iou": [((cost, a, b), {}),
                     ((np.float32([[0.3]]), np.float32([[0, 0, 100, 100]]),
                       np.float32([[0, 0, 100, 100]])), {})],
        "fuse_motion": [((cost, gating), {}),
                        ((cost, gating), {"only_position": True, "lam": 0.9}),
                        ((np.float32([[0.4, 0.4]]),
                          np.float32([[1.0, matching.CHI2INV95[3] + 1.0]])),
                         {"lam": 0.98})],
    }
    fn = name.removesuffix("_cosine").removesuffix("_euclidean")
    for args, kw in cases[name]:
        got = as_np(getattr(matching, fn)(*(torch.from_numpy(x) for x in args),
                                          **kw))
        want = np.asarray(getattr(jax_matching, fn)(
            *(jnp.asarray(x) for x in args), **kw))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert matching.CHI2INV95 == jax_matching.CHI2INV95
    with pytest.raises(ValueError):
        matching.embedding_distance(torch.zeros(1, 2), torch.zeros(1, 2),
                                    "bogus")


def test_ops_exports_match_the_jax_package():
    import motcpp_tpu.ops as jax_ops
    import motcpp_tpu_torch.ops as port_ops

    assert port_ops.__all__ == jax_ops.__all__
    assert port_ops.linear_assignment_masked is \
        matching.linear_assignment_masked


# ---------------------------------------------------------------------------
# 11. deterministic scenes
# ---------------------------------------------------------------------------

def assert_same_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scene", ["camera_pan_scene", "ablation_scene"])
def test_scenes_equal_the_jax_package(scene, seed):
    kw = dict(dropout_frames={1: {3, 4}}) if scene == "camera_pan_scene" \
        else {}
    assert_same_tree(getattr(synthetic, scene)(seed=seed, **kw),
                     getattr(jax_synthetic, scene)(seed=seed, **kw))


# ---------------------------------------------------------------------------
# 12. visualization
# ---------------------------------------------------------------------------

VIS_MODULES = {"motcpp_tpu.utils.visualization": visualization,
               "motcpp_tpu.models.base": port_base}


@pytest.mark.parametrize("case,name,kwargs", jax_cases(test_aux, [
    "test_plot_results_and_gif", "test_id_to_color_deterministic",
    "test_plot_results_extras_and_grid", "test_trajectory_history_capped"]))
def test_jax_visualization_cases_pass_against_the_port(case, name, kwargs,
                                                       monkeypatch, tmp_path):
    run_jax_case(test_aux, name, kwargs, monkeypatch, modules=VIS_MODULES,
                 tmp_path=tmp_path)


def test_visualization_arrays_equal_the_jax_package(tmp_path):
    from motcpp_tpu.models.base import id_to_color

    img = np.random.default_rng(0).integers(0, 255, (240, 320, 3), np.uint8)
    tracks = np.array([[10, 30, 60, 120, 3, 0.87, 0, 0],
                       [100, 40, 180, 200, 12, 0.5, 0, 1]], np.float32)
    frames = {}
    for mod in (visualization, jax_vis):
        hist = {}
        for t in range(3):
            f = mod.plot_results(img, tracks + [t, 0, t, 0, 0, 0, 0, 0],
                                 show_trajectories=True, history=hist,
                                 show_conf=True, header=f"frame {t}")
        frames[mod] = (f, hist, mod.make_grid({"a": f, "b": img}, cols=2))
        mod.save_gif([f, img], tmp_path / f"{mod.__name__}.gif", fps=5)
    (fp, hp, gp), (fj, hj, gj) = frames[visualization], frames[jax_vis]
    assert fp.dtype == fj.dtype and np.array_equal(fp, fj)
    assert hp == hj and np.array_equal(gp, gj)
    assert (tmp_path / f"{visualization.__name__}.gif").read_bytes() == \
        (tmp_path / f"{jax_vis.__name__}.gif").read_bytes()
    assert [port_base.id_to_color(i) for i in range(-5, 500)] == \
        [id_to_color(i) for i in range(-5, 500)]


def test_visualization_imports_cv2_and_pil_only_when_it_draws():
    code = ("import sys\n"
            "import motcpp_tpu_torch.utils.visualization\n"
            "import motcpp_tpu_torch.models.base\n"
            "sys.exit(1 if {'cv2', 'PIL'} & set(sys.modules) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
