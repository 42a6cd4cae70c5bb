"""Port parity: UCMCTrack's detection mapper, its step (started from a
JAX state taken mid-scene), host wrapper, the eval CLI and the
multi-stream runner at bench.py's config, of motcpp_tpu_torch against
the JAX package on the same seeded inputs and the goldens it pins.

Integer state, masks and ids must be identical, and the emitted rows
too: they are the raw detection boxes. Float state is compared at rtol
1e-5 with the atol that ``FLOAT_ATOL`` states per mapping and field.
On the image plane (0.01 px scale) XLA's fused multiply-adds in the
predict and the update move the state by at most 2e-5; through the
calibration the ground-plane positions reach 10-200 m, where one float32
ulp is 1e-6 to 2e-5 m, and the velocities (the position gain over
dt = 1/30 s) carry that ulp times 30.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.models import ucmctrack as ju
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.cli import build_tracker
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models import ucmctrack as pu
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from test_torch_golden import check_goldens

import torch_threads  # noqa: F401  (torch at one thread)


# a camera 3 m above the ground looking along it (JAX tests/test_ucmctrack.py)
KI = (1000.0, 0.0, 960.0, 0.0,
      0.0, 1000.0, 540.0, 0.0,
      0.0, 0.0, 1.0, 0.0)
KO = (1.0, 0.0, 0.0, 0.0,
      0.0, 0.0, 1.0, -3.0,
      0.0, -1.0, 0.0, 6.0,
      0.0, 0.0, 0.0, 1.0)
MAPPINGS = {"image": {}, "calibrated": {"Ki": KI, "Ko": KO}}
INT_FIELDS = ("ustate", "tid", "death", "birth", "det_idx", "next_id",
              "frame_count")
FLOAT_ATOL = {
    # measured worst 1.6e-5 on x, 0 on P
    "image": {"x": 1e-4, "P": 0, "out_conf": 0, "out_cls": 0, "out_box": 0},
    # measured worst 1.4e-3 on x (a velocity), 5.4e-4 on P
    "calibrated": {"x": 2e-3, "P": 1e-3, "out_conf": 0, "out_cls": 0,
                   "out_box": 0},
}


def scene(S=4, T=24, N=8, n_obj=6, seed=0):
    """synth_stream_dets with 30% of the confidences drawn in [0.2, 0.6):
    below det_thresh (ignored), low (stage 2) or high; a dropout that
    coasts stream 0's first three objects, and one of six frames that
    kills stream S-1's tracks."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.3
    dets[..., 4] = np.where(low, rng.uniform(0.2, 0.6, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[6:9, 0, :3] = False
    masks[9:15, -1] = False
    return dets, masks


def assert_state_equal(state, jstate, atols):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    for name, atol in atols.items():
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
def test_map_dets_matches_jax(mapping):
    dets, _ = synth_stream_dets(np.random.default_rng(1), 3, 4, 8, n_obj=8)
    boxes = dets.reshape(-1, 6)[:, :4]
    jcfg = ju.UCMCConfig(**MAPPINGS[mapping])
    cfg = pu.UCMCConfig(**MAPPINGS[mapping])
    inv_a = cfg.inv_A()
    np.testing.assert_array_equal(inv_a, jcfg.inv_A())
    want = jax.jit(lambda b: ju._map_dets(jcfg, b))(jnp.asarray(boxes))
    got = pu._map_dets(cfg, torch.from_numpy(boxes).reshape(4, -1, 4),
                       None if inv_a is None else torch.from_numpy(inv_a))
    for g, w in zip(got, want):
        g = g.reshape(np.shape(w)).numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mapping,lap", [
    ("image", "jv"), ("calibrated", "jv"), ("image", "auction_pallas"),
    ("calibrated", "auction_pallas")])
def test_step_matches_jax_from_a_mid_scene_state(mapping, lap):
    """The JAX step runs 10 frames; its state (coasted and tentative
    tracks present) goes over with state_from_numpy, and both steps run
    the next 14 frames, which bring low dets, deaths and rebirths."""
    cfg = dict(max_tracks=16, max_dets=8, max_age=4, lap_impl=lap,
               **MAPPINGS[mapping])
    dets, masks = scene()
    S, T0 = dets.shape[1], 10
    jinit, jcore = ju.make_ucmctrack(ju.UCMCConfig(**cfg))
    jstep = jax.jit(jax.vmap(jcore))
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    for t in range(T0):
        jstate, _ = jstep(jstate, jnp.asarray(dets[t]), jnp.asarray(masks[t]))
    arrays = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    assert (arrays["ustate"] == ju.TENTATIVE).any()
    assert (arrays["ustate"] == ju.COASTED).any()
    state = pu.state_from_numpy(arrays, device="cpu")
    for name, arr in pu.state_to_numpy(state).items():
        np.testing.assert_array_equal(arr, arrays[name], err_msg=name)
    _, step = pu.make_ucmctrack(pu.UCMCConfig(**cfg), device="cpu")
    next_id0 = arrays["next_id"].copy()
    for t in range(T0, dets.shape[0]):
        jstate, (jout, jmask) = jstep(jstate, jnp.asarray(dets[t]),
                                      jnp.asarray(masks[t]))
        state, (out, mask) = step(state, torch.from_numpy(dets[t]),
                                  torch.from_numpy(masks[t]))
        assert_state_equal(state, jstate, FLOAT_ATOL[mapping])
        jmask = np.asarray(jmask)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        np.testing.assert_array_equal(out.numpy()[jmask],
                                      np.asarray(jout)[jmask])
    assert (state.next_id.numpy() > next_id0).any()  # births after deaths


def test_wrapper_matches_jax_wrapper():
    """update() frame by frame, empty frames included, and reset."""
    dets, masks = scene(S=1, T=16, seed=3)
    masks[5:7] = False
    kw = dict(max_tracks=16, max_dets=8, max_age=3, dt=1.0 / 25)
    tr = create_tracker("ucmc", device="cpu", **kw)
    jtr = ju.UCMCTrack(**kw)

    def run(tracker):
        return [np.asarray(tracker.update(dets[t, 0][masks[t, 0]], None))
                for t in range(dets.shape[0])]

    outs = run(tr)
    for got, want in zip(outs, run(jtr)):
        assert got.shape == want.shape and got.shape[1] == 8
        np.testing.assert_array_equal(got, want)
    assert sum(len(o) for o in outs) > 0
    tr.reset()
    for a, b in zip(run(tr), outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["golden", "golden_long"])
def test_port_cli_writes_ucmctrack_goldens(which, tmp_path):
    check_goldens("ucmctrack", which, tmp_path)


def test_build_tracker_gives_ucmctrack_dt_from_fps():
    """The eval tool's dt = 1/fps (JAX cli.py:45-47); UCMCTrack takes no
    ReID weights."""
    for name in ("ucmctrack", "ucmc"):
        tr = build_tracker(name, fps=25, reid_weights="w.pt", device="cpu")
        assert isinstance(tr, pu.UCMCTrack)
        assert tr.cfg.dt == 1.0 / 25
    assert build_tracker("ucmctrack", device="cpu").cfg.dt == 1.0 / 30


@pytest.mark.parametrize("lap", ["jv", "auction_pallas"])
def test_runner_at_bench_config_matches_jax_runner(lap):
    """bench.py's UCMCTrack config (the defaults; bench.py:128-133), over
    two run() calls. Every confidence of synth_stream_dets is in
    [0.5, 1.0), so stage 2's problems are empty."""
    S, K, N, T = 8, 16, 8, 20
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N, n_obj=6)
    cfg = dict(max_tracks=K, max_dets=N, lap_impl=lap)
    jinit, jstep = ju.make_ucmctrack(ju.UCMCConfig(**cfg))
    jrunner = JaxRunner(jinit, jstep, S, devices=jax.devices()[:1])
    init, step = pu.make_ucmctrack(pu.UCMCConfig(**cfg), device="cpu")
    runner = MultiStreamRunner(init, step, S, device="cpu")
    for sl in (slice(0, 12), slice(12, T)):
        jouts, jmasks = jrunner.run(dets[sl], masks[sl])
        outs, omasks = runner.run(dets[sl], masks[sl])
        jmasks = np.asarray(jmasks)
        np.testing.assert_array_equal(omasks.numpy(), jmasks)
        np.testing.assert_array_equal(outs.numpy()[jmasks],
                                      np.asarray(jouts)[jmasks])
    assert jmasks.sum() > 0
