"""Port parity: the serving tail-latency harness and the SLO sweep of
motcpp_tpu_torch (``motcpp_tpu_torch/scripts/``) against the JAX
package's ``scripts/serving_latency.py`` and ``scripts/slo_sweep.py``,
and the TrackingService fed tick inputs that a mux hands over as tensors
(the harness's ``--device-data`` ring) against the same service fed the
same frames through its mux.

Inside the port the ring path is bit for bit the mux path; against the
JAX service fed the JAX harness's ring of ``jnp`` arrays, ids, classes,
detection indices and emission masks are identical, confidences agree at
rtol 1e-5 and boxes within 1e-3 px (``test_torch_serving``'s
tolerances). The JAX scripts are loaded from their files; their
``synth_frame`` and the sweep's walk are held against the port's.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25
from motcpp_tpu_torch.appearance.reid import make_embed_fn
from motcpp_tpu_torch.scripts import serving_latency as harness
from motcpp_tpu_torch.scripts import slo_sweep
from motcpp_tpu_torch.serving import StreamMux
from test_torch_serving import (
    HW,
    assert_same_rows,
    jax_service,
    live_service,
    port_service,
    stream_frames,
)

ROOT = Path(__file__).resolve().parent.parent
S, N, N_LIVE = 4, 8, 3


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_harness():
    return load_jax_script("serving_latency")


# ---------------------------------------------------------------------------
# (i) the harness's detections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_obj,max_dets",
                         [(0, 14, 32), (1, 14, 16), (7, 4, 8), (1000, 40, 32),
                          (1003, 0, 8)])
def test_synth_frame_equals_the_jax_harness(jax_harness, seed, n_obj,
                                            max_dets):
    """The same numpy draws in the same order: equal frames, and an
    equal generator state after five frames."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        got = harness.synth_frame(a, n_obj, max_dets)
        want = jax_harness.synth_frame(b, n_obj, max_dets)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert a.bit_generator.state == b.bit_generator.state


def test_staged_frames_equal_the_jax_device_ring(jax_harness):
    """The --device-data ring's dets and masks are the JAX harness's:
    default_rng(0), entry by entry, stream by stream."""
    R, n_obj = harness.ring_length(3), 5
    assert R == 9 and harness.ring_length(0) == harness.ring_length(8) == 8
    dets, mask = harness.staged_frames(R, S, N, n_obj)
    rng = np.random.default_rng(0)
    for r in range(R):
        for s in range(S):
            d = jax_harness.synth_frame(rng, n_obj, N)
            np.testing.assert_array_equal(dets[r, s, :len(d)], d)
            assert not dets[r, s, len(d):].any()
            assert mask[r, s].sum() == len(d) and mask[r, s, :len(d)].all()


# ---------------------------------------------------------------------------
# (ii)-(iii) device-resident tick inputs in TrackingService
# ---------------------------------------------------------------------------


def ring_ticks(R):
    """R ticks of S streams of boxes moving at (3, 1.5) px a frame,
    packed to N rows: (R, S, N, 6) float32 and (R, S, N) bool."""
    dets = np.zeros((R, S, N, 6), np.float32)
    mask = np.zeros((R, S, N), bool)
    for s in range(S):
        for t, f in enumerate(stream_frames(30 + s, R, n=3 + s)):
            dets[t, s, :len(f)] = f
            mask[t, s, :len(f)] = True
    return dets, mask


def serve_ring(svc, ring, T):
    """T ticks of ``ring`` ((dets, mask, crops) tensors) handed to
    ``svc`` by the harness's DeviceRingMux, the first N_LIVE streams
    attached; every batch."""
    for _ in range(N_LIVE):
        svc.attach()
    svc.mux = harness.DeviceRingMux(ring, S, N_LIVE, svc.device)
    return [svc.step() for _ in range(T)]


def serve_mux(svc, dets, mask, T, crops=None):
    """The same ticks through the service's own mux: tick t submits entry
    t % R of each of the first N_LIVE streams."""
    hs = [svc.attach() for _ in range(N_LIVE)]
    out = []
    for t in range(T):
        r = t % len(dets)
        for s, h in enumerate(hs):
            n = int(mask[r, s].sum())
            svc.submit(h, dets[r, s, :n],
                       crops=None if crops is None else crops[r, s, :n])
        out.append(svc.step())
    return out


def assert_bit_for_bit(got, want):
    emitted = 0
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.present, w.present)
        np.testing.assert_array_equal(g.out_masks, w.out_masks)
        np.testing.assert_array_equal(g.outs[g.out_masks],
                                      w.outs[w.out_masks])
        emitted += int(g.out_masks.sum())
    assert emitted > 0


class JaxRingMux:
    """The JAX harness's DeviceRingMux (scripts/serving_latency.py:
    248-259) over a ring of jnp arrays."""

    def __init__(self, ring):
        self.ring, self.t = ring, 0
        self.warps = jnp.tile(jnp.asarray(np.eye(2, 3, dtype=np.float32)),
                              (S, 1, 1))
        self.present = np.zeros(S, bool)
        self.present[:N_LIVE] = True

    def assemble(self):
        dets, mask = self.ring[self.t % len(self.ring)]
        self.t += 1
        return dets, mask, None, self.warps, self.present, None


def test_service_takes_device_tensors_from_a_mux():
    """Motion-only ByteTrack, S=4 with 3 live streams, a ring of 4 ticks
    served 8 times (the ring wraps, so a step that wrote into an input it
    was handed would show): the ring of tensors emits bit for bit what
    the same dets through the native mux emit; the JAX service fed the
    JAX harness's ring of jnp arrays emits the same rows."""
    R, T = 4, 8
    dets, mask = ring_ticks(R)
    ring = [(torch.from_numpy(d), torch.from_numpy(m), None)
            for d, m in zip(dets, mask)]
    got = serve_ring(port_service(n_streams=S), ring, T)
    via_mux = port_service(n_streams=S)
    assert isinstance(via_mux.mux, StreamMux)
    assert_bit_for_bit(got, serve_mux(via_mux, dets, mask, T))
    for (d, m, _), r in zip(ring, range(R)):  # the ring was not written
        assert torch.equal(d, torch.from_numpy(dets[r]))
        assert torch.equal(m, torch.from_numpy(mask[r]))

    jsvc = jax_service(n_streams=S)
    for _ in range(N_LIVE):
        jsvc.attach()
    jsvc.mux = JaxRingMux([(jnp.asarray(d), jnp.asarray(m))
                           for d, m in zip(dets, mask)])
    for g in got:
        w = jsvc.step()
        np.testing.assert_array_equal(g.present, w.present)
        np.testing.assert_array_equal(g.out_masks, w.out_masks)
        for s in range(S):
            m = g.out_masks[s]
            assert_same_rows(g.outs[s][m], w.outs[s][m])


def test_service_refuses_a_tensor_on_another_device():
    """A tensor that a mux hands over must lie on the service's device:
    one on another device raises and is not copied across."""
    dets, mask = ring_ticks(1)
    ring = [(torch.from_numpy(dets[0]).to("meta"),
             torch.from_numpy(mask[0]).to("meta"), None)]
    with pytest.raises(ValueError, match="tensors only on cpu"):
        serve_ring(port_service(n_streams=S), ring, 1)


@pytest.fixture(scope="module")
def module_embed():
    """The harness's kind of embed (the module forward, float32 on the
    CPU) of a seeded osnet_x0_25 at feature_dim 16."""
    return make_embed_fn(init_params(osnet_x0_25(feature_dim=16), 0),
                         device="cpu")


@pytest.mark.parametrize("kw", [
    dict(emb_cadence=2),
    dict(emb_cadence=2, cadence_compact=False),
    dict(crop_budget=6, emb_priority=True),
], ids=["cadence_compact", "cadence_full", "priority"])
def test_live_service_takes_device_crops_from_a_mux(module_embed, kw):
    """Live BoT-SORT (osnet_x0_25, 32x16 crops) fed a ring of dets,
    masks and crops as tensors emits bit for bit what the same frames and
    crops through the mux emit: at a cadence with the scheduled slots'
    crop rows taken from the tensor (compacted) or all of them, and at a
    priority budget, which holds the previous tick's dets and masks."""
    R, T = 4, 8
    dets, mask = ring_ticks(R)
    crops = np.random.default_rng(5).integers(
        0, 255, (R, S, N) + HW + (3,)).astype(np.uint8)
    ring = [tuple(torch.from_numpy(a) for a in e)
            for e in zip(dets, mask, crops)]
    a = live_service(module_embed, n_streams=S, **kw)
    assert a._cad_compact == kw.get("cadence_compact", "emb_cadence" in kw)
    got = serve_ring(a, ring, T)
    want = serve_mux(live_service(module_embed, n_streams=S, **kw), dets,
                     mask, T, crops)
    assert_bit_for_bit(got, want)
    for (_, _, c), r in zip(ring, range(R)):
        assert torch.equal(c, torch.from_numpy(crops[r]))


# ---------------------------------------------------------------------------
# (iv) the harness in process, on the CPU
# ---------------------------------------------------------------------------

TINY = ["--tracker", "bytetrack", "--streams", "4", "--max-dets", "8",
        "--max-tracks", "16", "--objects", "4", "--producers", "2",
        "--warmup", "2", "--ticks", "6"]


def check_row(row, report, n_live):
    qs = [row[k] for k in ("p50", "p90", "p95", "p99", "max")]
    assert np.all(np.isfinite(qs)) and qs == sorted(qs)
    assert row["device"] == "cpu" and "power_limit" not in row
    assert row["live"] == n_live
    assert report["presents"] and set(report["presents"]) == {n_live}
    assert report["stats"]["dropped"] == 0


def test_harness_row_carries_the_jax_harness_keys(tmp_path):
    """The port's harness under --cpu (producer threads through the
    native mux) gives a row with every key of the JAX harness's row on the
    same flags, under the JAX metric with ``torch_`` in front; its
    percentiles are ordered and every tick had every live stream."""
    report = {}
    row = harness.measure(harness.parser().parse_args(TINY + ["--cpu"]),
                          report=report)
    assert report["native_mux"]
    assert len(report["presents"]) == 2 + 6
    check_row(row, report, 4)
    # one CPU device (not the suite's eight: S=4 would not divide), its
    # compilation cache under tmp_path
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "serving_latency.py")]
        + TINY + ["--cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(want) <= set(row)
    assert row["metric"] == "torch_" + want["metric"]


def test_harness_pipelined_device_data_on_the_cpu():
    """--pipeline --device-data at depth 3 with half the slots live: the
    interval and the dispatch-to-fetch times, every dispatched tick
    resolved (warm-up, depth and drain included)."""
    report = {}
    args = harness.parser().parse_args(
        TINY + ["--cpu", "--pipeline", "--pipeline-depth", "3",
                "--device-data", "--occupancy", "0.5"])
    row = harness.measure(args, report=report)
    assert row["metric"] == ("torch_bytetrack_pipelined_pd3_devdata_"
                             "serving_tick_latency_ms")
    assert report["native_mux"]
    assert len(report["presents"]) == 2 + 3 + 6
    check_row(row, report, 2)
    assert row["e2e_p50_ms"] >= row["p50"]


def test_harness_refuses_live_reid_on_a_motion_tracker():
    with pytest.raises(ValueError, match="appearance tracker"):
        harness.measure(harness.parser().parse_args(
            TINY + ["--cpu", "--live-reid"]))


# ---------------------------------------------------------------------------
# (v)-(vi) the SLO sweep
# ---------------------------------------------------------------------------

FLOOR_P99 = 5.0
# p99 of each scripted point; None: the run fails
SCRIPTED_P99 = {
    ("strongsort", 32): 50.0, ("strongsort", 16): 36.0,  # passes net only
    ("hybridsort", 32): None, ("hybridsort", 16): 60.0,
    ("hybridsort", 8): 45.0,                             # no passing point
    ("boosttrack", 64): 20.0,                            # passes at the top
    ("botsort", 128): 80.0, ("botsort", 64): 33.0,       # at the limit
    ("deepocsort", 128): 40.0, ("deepocsort", 64): 38.5,
    ("deepocsort", 32): 30.0,
}


def scripted(argv):
    """A made-up harness row for ``argv``: the null row, a sweep point of
    SCRIPTED_P99 (raising where it is None), or the producer row."""
    args = harness.parser().parse_args(argv)
    if args.live_reid and args.device_data:
        p99 = SCRIPTED_P99[(args.tracker, args.streams)]
        if p99 is None:
            raise RuntimeError("scripted failure")
    else:
        p99 = FLOOR_P99 if args.device_data else 70.0
    return {"metric": harness.metric_name(args), "p50": p99 - 2,
            "p90": p99 - 1, "p95": p99 - 0.5, "p99": p99, "max": p99 + 1,
            "e2e_p50_ms": 2 * p99, "e2e_p99_ms": 3 * p99,
            "streams": args.streams}


def fake_subprocess(cmd, **kw):
    try:
        row = scripted(cmd[2:])
    except RuntimeError:
        return subprocess.CompletedProcess(cmd, 1, "", "Traceback\nboom\n")
    return subprocess.CompletedProcess(cmd, 0, json.dumps(row) + "\n", "")


@pytest.mark.parametrize("tracker", ["", "deepocsort", "hybridsort"])
def test_sweep_walks_as_the_jax_sweep(tracker, tmp_path, monkeypatch):
    """On the same scripted rows the port's walk gives the JAX script's
    summary and rows: a point that passes only net of the floor, one at
    the limit, a failed point (an error row), a tracker with no passing
    point, and the null and producer rows of the full sweep."""
    jmod = load_jax_script("slo_sweep")
    monkeypatch.setattr(jmod, "subprocess", types.SimpleNamespace(
        run=fake_subprocess, TimeoutExpired=subprocess.TimeoutExpired))
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["slo_sweep.py", "--out", str(out),
                                      "--ticks", "7"]
                        + (["--tracker", tracker] if tracker else []))
    jmod.main()
    want = json.loads(out.read_text())
    assert jmod.DEPLOYED == slo_sweep.DEPLOYED
    assert jmod.LADDER == slo_sweep.LADDER and jmod.SLO_MS == slo_sweep.SLO_MS

    got = slo_sweep.sweep(tracker, ticks=7, cpu=True, run=scripted)
    assert got["summary"] == want["summary"]
    if not tracker:
        assert got["summary"]["hybridsort"] == "NO PASSING POINT"
        assert got["summary"]["strongsort"]["streams"] == 16
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"], want["rows"]):
        for key in ("tracker", "streams", "meets_slo", "p99",
                    "p99_net_of_floor", "meets_slo_net", "role", "slo_ms"):
            assert g.get(key) == w.get(key), (key, g, w)
        assert ("error" in g) == ("error" in w)
        assert ("mode" in g) == ("mode" in w)
        if "metric" in g:
            assert g["metric"].startswith("torch_")


def test_sweep_writes_its_own_file_never_the_jax_table(monkeypatch, capsys):
    """A tiny real sweep on the CPU (BoT-SORT at cadence 8, osnet_x0_25,
    S=8, one timed tick) writes the default --out, under the port's
    gitignored build directory; tests/serving_slo.json, the JAX
    package's table, is byte for byte as it was."""
    table = ROOT / "tests" / "serving_slo.json"
    before = table.read_bytes()
    assert slo_sweep.OUT == ROOT / "motcpp_tpu_torch" / "_build" / \
        "serving_slo_torch.json"
    monkeypatch.setattr(slo_sweep, "LADDER", {"botsort": [8]})
    monkeypatch.setattr(slo_sweep, "DEPLOYED", {"botsort": [
        "--emb-cadence", "8", "--reid-variant", "x0_25"]})
    slo_sweep.main(["--tracker", "botsort", "--ticks", "1", "--cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"metric": "serving_slo_sweep",
                    "passing": last["passing"], "total": 1}
    rec = json.loads(slo_sweep.OUT.read_text())
    (row,) = rec["rows"]
    assert row["metric"] == ("torch_botsort_livereid_x0_25_ec8_pipelined_"
                             "pd4_devdata_serving_tick_latency_ms")
    assert row["streams"] == 8 and row["device"] == "cpu"
    assert rec["_meta"]["card"] == "cpu"
    assert table.read_bytes() == before
