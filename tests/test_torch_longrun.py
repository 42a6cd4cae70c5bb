"""Port parity: the long-horizon streaming tool of motcpp_tpu_torch
(``motcpp_tpu_torch/scripts/longrun_stability.py``) against the JAX
package's ``scripts/longrun_stability.py``, loaded with ``importlib``.

The JAX script's own scene (its ``make_device_scene`` on the CPU) is cut
into chunks and handed to both packages as numpy arrays: the port's
chunk loop and the JAX ``MultiStreamRunner`` must emit identical masks
and ids, boxes within 1e-3 px, integer state equal and float state at
rtol 1e-5 (OC-SORT's x at atol 2e-3 as well: XLA's fused multiply-adds,
ROADMAP queue 3). The port's chunked rollout must equal its unchunked
one bit for bit. The port's scene is torch's draws, so it is held to the
JAX scene's statistics, not its boxes.
"""

import argparse
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from motcpp_tpu_torch.scripts import longrun_stability
from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns
from motcpp_tpu_torch.utils.profiling import same_bits

import torch_threads  # noqa: F401  (torch at one thread)

ROOT = Path(__file__).resolve().parent.parent
S, K, N, CHUNK, N_CHUNKS = 4, 64, 32, 20, 3
ARGV = ["--cpu", "--streams", str(S), "--frames", str(CHUNK * N_CHUNKS),
        "--chunk", str(CHUNK)]
# float state fields compared with an absolute tolerance beside rtol 1e-5
STATE_ATOL = {"bytetrack": {}, "ocsort": {"x": 2e-3}}


def load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_longrun_stability",
        ROOT / "scripts" / "longrun_stability.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_chunks(jscript, S, N, T, n_chunks):
    """The JAX script's scene cut as its main() cuts it: (dets, masks)
    numpy arrays over n_chunks * T frames."""
    import functools

    scene_init, scene_chunk = jscript.make_device_scene(S, N)
    scene_chunk = functools.partial(scene_chunk, T=T)
    key = jax.random.PRNGKey(0)
    scene = scene_init(key)
    dets, masks = [], []
    for _ in range(n_chunks):
        key, sub = jax.random.split(key)
        scene, d, m = scene_chunk(sub, scene)
        dets.append(np.asarray(d))
        masks.append(np.asarray(m))
    return np.concatenate(dets), np.concatenate(masks)


@pytest.fixture(scope="module")
def jscript():
    return load_jax_script()


@pytest.fixture(scope="module")
def jax_scene(jscript):
    return jax_chunks(jscript, S, N, CHUNK, N_CHUNKS)


def collect(into):
    def on_chunk(c, runner, dets, masks, outs, out_masks):
        into.append((outs.clone(), out_masks.clone()))

    return on_chunk


def assert_states_close(state, jstate, atol):
    for name in state._fields:
        got = getattr(state, name).numpy()
        want = np.asarray(getattr(jstate, name))
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=atol.get(name, 0), err_msg=name)


@pytest.mark.parametrize("tracker", ["bytetrack", "ocsort"])
def test_chunked_rollout_matches_jax_runner(jax_scene, tracker):
    """Three chunks of 20 frames, the state carried across run() calls
    on both sides, at the script's widths (K=64, N=32, the auction)."""
    dets, masks = jax_scene
    args = argparse.Namespace(max_tracks=K, max_dets=N, lap="auction_pallas",
                              emb_dim=0, objects=16)
    jinit, jstep = bench.build_tracker_fns(tracker, args)
    jrunner = JaxRunner(jinit, jstep, S, devices=jax.devices()[:1])
    got = []
    report = longrun_stability.run(
        longrun_stability.parser().parse_args(ARGV + ["--tracker", tracker]),
        scene=(dets, masks), on_chunk=collect(got))
    assert report["failed"] is None and len(got) == N_CHUNKS
    for c, (outs, out_masks) in enumerate(got):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        jouts, jmasks = jrunner.run(dets[sl], masks[sl])
        jmasks = np.asarray(jmasks)
        np.testing.assert_array_equal(out_masks.numpy(), jmasks)
        g, w = outs.numpy()[jmasks], np.asarray(jouts)[jmasks]
        np.testing.assert_array_equal(g[:, 4], w[:, 4])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
    assert report["emissions"] == int(
        sum(int(m.sum()) for _, m in got)) > 0
    assert_states_close(report["states"], jrunner.states,
                        STATE_ATOL[tracker])


@pytest.mark.parametrize("tracker", ["bytetrack", "ocsort"])
def test_chunked_rollout_equals_unchunked_bit_for_bit(tracker):
    """The script's chunks (the scene made in chunks on the device)
    against one run() over the same frames."""
    chunks, scene = [], []

    def on_chunk(c, runner, dets, masks, outs, out_masks):
        chunks.append((outs, out_masks))
        scene.append((dets, masks))

    report = longrun_stability.run(
        longrun_stability.parser().parse_args(ARGV + ["--tracker", tracker]),
        on_chunk=on_chunk)
    init, step = build_tracker_fns(tracker, K, N, "auction_pallas",
                                   device="cpu")
    runner = MultiStreamRunner(init, step, S, device="cpu")
    outs, out_masks = runner.run(torch.cat([d for d, _ in scene]),
                                 torch.cat([m for _, m in scene]))
    assert same_bits(out_masks, torch.cat([m for _, m in chunks]))
    assert same_bits(outs, torch.cat([o for o, _ in chunks]))
    for a, b in zip(runner.states, report["states"]):
        assert same_bits(a, b)
    assert report["max_next_id"] >= 16 and report["emissions"] > 0


def test_port_scene_matches_jax_scene_statistics(jscript):
    """S=64, T=200 of each scene: the dropout share, the confidence
    range, the box sizes and the per-frame displacement of the visible
    objects, within bounds that 64 x 16 x 200 draws keep (the share's
    standard error is 0.0006)."""
    T, Sx = 200, 64
    jd, jm = jax_chunks(jscript, Sx, N, T, 1)
    init, chunk = longrun_stability.make_device_scene(Sx, N, device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, d, m = chunk(gen, init(gen), T)
    stats = []
    for dets, masks in ((d.numpy(), m.numpy()), (jd, jm)):
        obj = dets[:, :, :16]
        vis = masks[:, :, :16]
        assert not masks[:, :, 16:].any() and not dets[:, :, 16:].any()
        conf = obj[..., 4][vis]
        w = obj[..., 2] - obj[..., 0]
        h = obj[..., 3] - obj[..., 1]
        centre = (obj[..., :2] + obj[..., 2:4]) / 2
        step = np.abs(np.diff(centre, axis=0))  # (T-1, S, 16, 2)
        assert conf.min() >= 0.5 and conf.max() < 1.0
        assert w.min() >= 40 - 1e-3 and w.max() <= 120 + 1e-3
        assert h.min() >= 80 - 1e-3 and h.max() <= 240 + 1e-3
        # an object keeps its size
        assert np.abs(w - w[:1]).max() < 1e-3
        stats.append(np.array([1 - vis.mean(), conf.mean(), w.mean(),
                               h.mean(), step[..., 0].mean(),
                               step[..., 1].mean(), step[..., 0].max(),
                               step[..., 1].max()]))
    port, jax_stats = stats
    # dropout 0.05, conf mean 0.75, w mean 80, h mean 160 (1024 objects),
    # mean |dx| about 2.6 and |dy| about 1.5 px a frame (|v| + jitter)
    np.testing.assert_allclose(port[0], jax_stats[0], atol=0.004)
    np.testing.assert_allclose(port[0], 0.05, atol=0.004)
    np.testing.assert_allclose(port[1], jax_stats[1], atol=0.005)
    np.testing.assert_allclose(port[2:4], jax_stats[2:4], rtol=0.05)
    np.testing.assert_allclose(port[4:6], jax_stats[4:6], rtol=0.1)
    # the largest step: |v| <= 5 and 3 px, and a few sigma of jitter
    assert port[6] < 5 + 6 * 1.0 and port[7] < 3 + 6 * 0.5


def test_main_exits_0_and_prints_the_jax_summary_line(capsys):
    assert longrun_stability.main(ARGV) == 0
    out = capsys.readouterr().out.splitlines()
    # the JAX script's summary, its parenthetical the port's own
    assert re.fullmatch(
        rf"bytetrack: 60 frames x {S} streams stable — [\d,]+ emissions, "
        r"wall \d+s \(.*\)", out[-1])
    assert sum(ln.startswith("chunk ") for ln in out) == N_CHUNKS


def test_a_non_finite_emission_exits_1(monkeypatch, capsys):
    """A step that emits a NaN in its 25th frame: chunk 1 fails with the
    JAX script's message, and the run stops there."""
    calls = []

    def nan_step(tracker, *a, **kw):
        init, step = build_tracker_fns(tracker, *a, **kw)

        def step_fn(state, dets, masks):
            state, (out, out_mask) = step(state, dets, masks)
            calls.append(1)
            if len(calls) == CHUNK + 5:
                out = out.clone()
                out[out_mask] = float("nan")
            return state, (out, out_mask)

        return init, step_fn

    monkeypatch.setattr(longrun_stability, "build_tracker_fns", nan_step)
    assert longrun_stability.main(ARGV) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "FAIL: non-finite emission in chunk 1"
    assert len(calls) == 2 * CHUNK
