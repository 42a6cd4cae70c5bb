"""The port's scoreboard (``motcpp_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU.

* The port's CLI at the sizes of ``tests/test_bench.py`` (``--cpu
  --streams 8 --frames 4 --repeats 1 --max-tracks 16 --max-dets 8
  --objects 4``), run from a copy of the package beside copies of the
  root ``BENCH_*.json`` files: ``--quick`` prints nine rows with
  ByteTrack last, the ``--emb-dim`` and ``--lap jv`` rows, a capacity
  row through ``--metric-suffix``; each row has ``bench.py``'s keys and
  the ``torch_`` prefix. Every run writes only under
  ``motcpp_tpu_torch/_build/`` and leaves each ``BENCH_*.json`` as it
  was, byte for byte.
* For ByteTrack, SORT, StrongSORT with ``--emb-dim`` and BoT-SORT with
  ``--cmc warps``: the row's inputs (detections, masks, embeddings,
  warps, drawn from ``default_rng(0)`` at the same S, T and N) equal
  ``bench.py``'s, and the first rollout (the warm-up) through the port's
  runner emits what the JAX ``MultiStreamRunner`` built by
  ``bench.build_tracker_fns`` emits (``lap_impl "auction_pallas"``: the
  Pallas kernel in interpret mode there, the CUDA kernel's plain version
  here): identical masks, ids, classes and detection indices,
  confidences at rtol 1e-5, boxes within 1e-3 px (2e-3 for SORT, as
  ``tests/test_torch_tracker_fns.py``).
* One live-ReID leg: ``tests/test_torch_bench_live.py``.
* A leg that fails, or prints no row, is an error row and the
  scoreboard exits 1; the moved helpers (``utils/benchrun.py``, the
  auction bounds of ``utils/profiling.py``) on their own.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from bench_parity import (
    BOX_ATOL,
    KEYS,
    SMALL,
    jax_bench_args,
    recording,
    same_first_rollout,
)
from motcpp_tpu_torch import bench as port
from motcpp_tpu_torch.utils import benchrun, profiling

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def standalone(tmp_path_factory):
    """A copy of the port's package, without its builds, beside copies of
    the root BENCH_*.json files."""
    root = tmp_path_factory.mktemp("standalone")
    shutil.copytree(ROOT / "motcpp_tpu_torch", root / "motcpp_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for p in ROOT.glob("BENCH_*.json"):
        shutil.copy(p, root / p.name)
    return root


def tree(root):
    return {p.relative_to(root): digest(p) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def run_cli(root, *args):
    """The port's CLI at SMALL sizes from ``root``: its rows. It must
    exit 0 and change no file but under motcpp_tpu_torch/_build/."""
    before = tree(root)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "motcpp_tpu_torch.bench", *SMALL, *args],
        capture_output=True, text=True, timeout=600, cwd=root, env=env)
    assert r.returncode == 0, r.stderr
    after = tree(root)
    changed = {p for p in set(before) | set(after)
               if before.get(p) != after.get(p)}
    assert all(p.parts[:2] == ("motcpp_tpu_torch", "_build")
               for p in changed), changed
    benches = sorted(root.glob("BENCH_*.json"))
    assert [p.name for p in benches] == sorted(
        p.name for p in ROOT.glob("BENCH_*.json"))
    assert all(before[p.relative_to(root)] == digest(p) for p in benches)
    rows = [json.loads(line) for line in r.stdout.strip().splitlines()]
    for row in rows:
        assert set(row) == KEYS
        assert row["metric"].startswith("torch_")
        assert row["unit"] == "streams_at_30fps_per_chip"
        assert row["value"] > 0
        assert row["vs_baseline"] == pytest.approx(
            row["value"] / 256.0, abs=0.05 / 256.0 + 5e-4 + 1e-9)
    return rows


def test_quick_scoreboard_nine_rows_bytetrack_last(standalone):
    rows = run_cli(standalone, "--quick")
    metrics = [r["metric"] for r in rows]
    assert metrics == [f"torch_{t}_streams_at_30fps_per_chip"
                       for t in bench.ALL_TRACKERS]
    written = json.loads((standalone / "motcpp_tpu_torch" / "_build"
                          / "bench_quick_torch.json").read_text())
    assert written["rows"] == rows and written["card"] == "cpu"


def test_emb_dim_row(standalone):
    (row,) = run_cli(standalone, "--tracker", "strongsort", "--emb-dim", "16")
    assert row["metric"] == "torch_strongsort_streams_at_30fps_per_chip"


def test_jv_row(standalone):
    (row,) = run_cli(standalone, "--lap", "jv", "--tracker", "sort")
    assert row["metric"] == "torch_sort_streams_at_30fps_per_chip"


def test_capacity_row_through_metric_suffix(standalone):
    suffix, ov = port.CAPACITY_ROWS[0]
    (row,) = run_cli(standalone, "--tracker", "bytetrack", "--max-tracks",
                     str(ov["max_tracks"]), "--max-dets", str(ov["max_dets"]),
                     "--objects", str(ov["objects"]), "--metric-suffix",
                     suffix)
    assert row["metric"] == f"torch_bytetrack{suffix}_streams_at_30fps_per_chip"


def test_row_plan_is_bench_pys():
    """The rows, their order, the saturation points and the deployed
    live-ReID points are bench.py's."""
    assert list(port.ALL_TRACKERS) == bench.ALL_TRACKERS
    assert port.ALL_TRACKERS[-1] == "bytetrack"
    assert port.DEFAULT_STREAMS == bench.DEFAULT_STREAMS
    assert port.DEFAULT_STREAMS_OTHER == bench.DEFAULT_STREAMS_OTHER
    assert port.CAPACITY_ROWS == bench.CAPACITY_ROWS
    assert port.CAPACITY_TRACKERS == bench.CAPACITY_TRACKERS
    assert port.DEPLOYED == bench.DEPLOYED
    args = port.parser().parse_args([])
    assert (args.frames, args.repeats, args.max_tracks, args.max_dets,
            args.objects, args.lap) == (60, 5, 64, 32, 16, "auction_pallas")
    labels = [label for _, label in port.legs(args)]
    assert labels == ["strongsort_cmc_ecc",
                      "strongsort_livereid_bf16_everyframe"] + [
        f"{t}_livereid_deployed" for t in bench.DEPLOYED]
    fused = port.legs(port.parser().parse_args(["--fused"]))
    assert [a.count("--fused") for a, _ in fused] == [0] + [1] * 6


def test_dw_impl_shift_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        port.main(["--cpu", "--dw-impl", "shift"])
    assert e.value.code == 2
    assert "one depthwise schedule" in capsys.readouterr().err


@pytest.mark.parametrize("tracker,extra", [
    ("bytetrack", {}), ("sort", {}), ("strongsort", {"emb_dim": 16}),
    ("botsort", {"cmc": "warps"})], ids=["bytetrack", "sort",
                                         "strongsort-emb", "botsort-warps"])
def test_row_inputs_and_first_rollout_equal_bench_pys(tracker, extra,
                                                     monkeypatch):
    import motcpp_tpu.parallel as jax_parallel

    seen = {}
    monkeypatch.setattr(jax_parallel, "MultiStreamRunner",
                        recording(jax_parallel.MultiStreamRunner, seen))
    want = bench.bench_one(tracker, jax_bench_args(**extra))
    (jdets, jmasks), jkw, jout = seen["call"]

    report = {}
    args = port.parser().parse_args(SMALL + ["--tracker", tracker])
    for k, v in extra.items():
        setattr(args, k, v)
    got = port.bench_one(tracker, args, report=report)
    S, dets, masks, host_kw = report["inputs"]
    assert S == 8
    np.testing.assert_array_equal(dets, np.asarray(jdets))
    np.testing.assert_array_equal(masks, np.asarray(jmasks))
    assert set(host_kw) == set(jkw) == ({"embs"} if "emb_dim" in extra else
                                        {"warps"} if "cmc" in extra else set())
    for k, v in host_kw.items():
        np.testing.assert_array_equal(v, np.asarray(jkw[k]))
    same_first_rollout(report["first"], jout, BOX_ATOL.get(tracker, 1e-3))
    assert got["metric"] == "torch_" + want["metric"]
    assert set(got) == set(want) == KEYS


def completed(rc, stdout="", stderr=""):
    return lambda cmd, **kw: subprocess.CompletedProcess(cmd, rc, stdout,
                                                         stderr)


@pytest.mark.parametrize("leg", [
    completed(1, stderr="Traceback\nRuntimeError: a fault of the leg"),
    completed(0, stdout="no row\n")], ids=["exit-1", "no-row"])
def test_a_failed_leg_fails_the_scoreboard(leg, monkeypatch, tmp_path,
                                           capsys):
    """The whole scoreboard at SMALL sizes, its seven legs made to fail:
    each is an error row in the written file, never printed as a row,
    and main() returns 1 after the flagship's row."""
    monkeypatch.setattr(port, "BUILD", tmp_path)
    monkeypatch.setattr(port.subprocess, "run", leg)
    assert port.main(SMALL) == 1
    printed = [json.loads(line)
               for line in capsys.readouterr().out.strip().splitlines()]
    rows = json.loads((tmp_path / port.QUICK_JSON).read_text())["rows"]
    errors = [r for r in rows if "error" in r]
    assert [r["metric"] for r in errors] == [
        f"torch_{label}" for _, label in port.legs(port.parser().parse_args(
            []))]
    assert [r for r in rows if "error" not in r] == printed
    assert len(printed) == 8 + 6 + 1
    assert printed[-1]["metric"] == "torch_bytetrack_streams_at_30fps_per_chip"
    assert printed[8]["metric"] == (
        "torch_strongsort_K128_N64_streams_at_30fps_per_chip")


def tiny_runner():
    from motcpp_tpu_torch.data import synth_stream_dets
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
    from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns

    init, step = build_tracker_fns("bytetrack", 16, 8, device="cpu")
    dets, masks = synth_stream_dets(np.random.default_rng(0), 3, 2, 8,
                                    n_obj=4)
    return (MultiStreamRunner(init, step, 2, device="cpu"),
            torch.from_numpy(dets), torch.from_numpy(masks))


@pytest.mark.parametrize("reset", [True, False])
def test_timed_runs_resets_or_carries_the_state(reset):
    runner, dets, masks = tiny_runner()
    run_s, times, first, last = benchrun.timed_runs(
        runner, dets, masks, repeats=2, reset=reset)
    assert len(times) == 2 and run_s == np.median(times)
    fresh = tiny_runner()[0]
    runs = [fresh.run(dets, masks) for _ in range(3)]  # each continues
    assert not torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(first, runs[0]))
    want = runs[0] if reset else runs[2]
    assert all(torch.equal(a, b) for a, b in zip(last, want))


def test_timed_runs_checks_the_launches():
    runner, dets, masks = tiny_runner()
    counter = types.ModuleType("fake_kernel")
    counter.LAUNCHES = 0
    benchrun.timed_runs(runner, dets, masks, (counter,), {counter: 0},
                        "fake", repeats=1)
    with pytest.raises(benchrun.CheckFailure,
                       match="fake run 0: 0 fake_kernel launches, want 3"):
        benchrun.timed_runs(runner, dets, masks, (counter,), {counter: 3},
                            "fake", repeats=1)


@pytest.mark.parametrize("per_frame,ok", [(6, True), (5, False)])
def test_fused_row_must_launch_six_osblocks_a_frame_of_each_run(
        per_frame, ok, monkeypatch):
    """On the card a ``--fused`` row launches the OSBlock kernel OSBLOCKS
    times a frame of every run, else it ran (some of) its blocks through
    the plain forward and is refused. Here the runner's run() stands for
    the card: it counts per_frame OSBlock and one auction launches a
    frame."""
    runner, dets, masks = tiny_runner()
    fake = {k: types.ModuleType(f"fake_{k}") for k in ("auction", "OSBlock")}
    for m in fake.values():
        m.LAUNCHES = 0
    run = runner.run

    def counted_run(d, m, **kw):
        fake["auction"].LAUNCHES += d.shape[0]
        fake["OSBlock"].LAUNCHES += per_frame * d.shape[0]
        return run(d, m, **kw)

    monkeypatch.setattr(runner, "run", counted_run)
    monkeypatch.setattr(port, "_counters", lambda: fake)
    args = port.parser().parse_args(["--repeats", "2"])
    timed = lambda: port._timed(runner, args, torch.device("cuda"), "leg",
                                dets, masks, None, ("auction", "OSBlock"))
    if ok:
        assert timed()[2] == {"auction": 9, "OSBlock": 54}
    else:
        with pytest.raises(RuntimeError, match="45 OSBlock kernel launches "
                           "over 3 runs, want at least 54"):
            timed()


def test_rolled_crops_are_bench_pys():
    crops0 = np.random.default_rng(0).integers(0, 255, (5, 2, 4, 3, 3)
                                               ).astype(np.uint8)
    got = benchrun.rolled_crops(torch.from_numpy(crops0), 4).numpy()
    np.testing.assert_array_equal(
        got, np.stack([np.roll(crops0, t, axis=0) for t in range(4)]))


def test_auction_bounds_count_the_sectors_of_valid_pairs():
    """One problem of 2 x 8 with one valid row: 8 valid pairs in one
    32-byte sector; the masks (10 bytes), the threshold (4) and the
    outputs (40) beside it; 16 operations."""
    cost = torch.zeros((1, 2, 8))
    rm = torch.tensor([[True, False]])
    cm = torch.ones((1, 8), dtype=torch.bool)
    th = torch.zeros(1)
    ms, by = profiling.auction_bound_ms(cost, rm, cm, th)
    assert by == "bytes"
    assert ms == pytest.approx((32 + 10 + 4 + 40) / profiling.HBM_BYTES_PER_S
                               * 1e3, rel=1e-12)
    assert profiling.full_tile_bound_ms(cost, rm, cm, th) == pytest.approx(
        (64 + 10 + 4 + 40) / profiling.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    rm[:] = False
    assert profiling.auction_bound_ms(cost, rm, cm, th)[0] == pytest.approx(
        (10 + 4 + 40) / profiling.HBM_BYTES_PER_S * 1e3, rel=1e-12)


def test_without_cpu_it_raises_where_there_is_no_card(monkeypatch, tmp_path,
                                                      capsys):
    """Without --cpu the scoreboard runs on the card: where there is none
    it raises before any row, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port, "BUILD", tmp_path)
    for argv in ([], ["--quick"], ["--tracker", "botsort", "--livereid"],
                 ["--tracker", "bytetrack", "--merge-full"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.main(argv)
    assert not list(tmp_path.iterdir())
    assert capsys.readouterr().out == ""
