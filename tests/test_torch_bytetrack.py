"""Port parity: ByteTrack step, state hand-over, host wrapper and the
multi-stream runner of motcpp_tpu_torch against the JAX package on the
same seeded scenes.

Integer state, masks and ids must be identical; float state and outputs
are compared at rtol 1e-5 (atol 0). The two sides do the same float32
operations in the same order, but XLA's CPU backend may fuse a multiply
and an add into one rounding where PyTorch rounds twice, so bit equality
is not required. Boxes emitted by the runners are compared to 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.models.bytetrack import ByteTrackConfig as JaxConfig
from motcpp_tpu.models.bytetrack import make_bytetrack as jax_make
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.bytetrack import (
    ByteState,
    ByteTrackConfig,
    make_bytetrack,
    state_from_numpy,
    state_to_numpy,
)
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

import torch_threads  # noqa: F401  (torch at one thread)

INT_FIELDS = ("tstate", "is_activated", "tid", "det_ind", "start_frame",
              "last_frame", "next_id", "frame_id")
FLOAT_FIELDS = ("mean", "cov", "conf", "cls")


def scene(S=4, T=16, N=8, n_obj=6, seed=0):
    """synth_stream_dets plus low-confidence dets, so all three stages,
    births, losses and aging all occur."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.25
    dets[..., 4] = np.where(low, rng.uniform(0.15, 0.44, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[8:11, 0] = False  # a gap long enough to lose tracks
    return dets, masks


def assert_state_equal(port_state, jax_state):
    got = state_to_numpy(port_state)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jax_state, name)),
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(got[name], np.asarray(getattr(jax_state, name)),
                                   rtol=1e-5, atol=0, err_msg=name)


def jax_vstep(cfg):
    init, step = jax_make(JaxConfig(**cfg))
    return init, jax.jit(jax.vmap(step))


@pytest.mark.parametrize("lap", ["jv", "auction_pallas"])
def test_step_matches_jax_frame_by_frame(lap):
    cfg = dict(max_tracks=16, max_dets=8, track_buffer=3, lap_impl=lap)
    dets, masks = scene()
    S = dets.shape[1]
    jinit, jstep = jax_vstep(cfg)
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    init, step = make_bytetrack(ByteTrackConfig(**cfg), device="cpu")
    state = init(S)
    for t in range(dets.shape[0]):
        jstate, (jout, jmask) = jstep(jstate, jnp.asarray(dets[t]),
                                      jnp.asarray(masks[t]))
        state, (out, mask) = step(state, torch.from_numpy(dets[t]),
                                  torch.from_numpy(masks[t]))
        assert_state_equal(state, jstate)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=0)
    # the scene reaches every lifecycle state
    assert {0, 1, 2} <= set(np.unique(np.asarray(state.tstate)))


def test_state_round_trip_and_mid_sequence_handover():
    cfg = dict(max_tracks=16, max_dets=8, track_buffer=3)
    dets, masks = scene(seed=1)
    S = dets.shape[1]
    jinit, jstep = jax_vstep(cfg)
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    for t in range(7):
        jstate, _ = jstep(jstate, jnp.asarray(dets[t]), jnp.asarray(masks[t]))

    arrays = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    state = state_from_numpy(arrays, device="cpu")
    assert isinstance(state, ByteState)
    back = state_to_numpy(state)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k

    _, step = make_bytetrack(ByteTrackConfig(**cfg), device="cpu")
    for t in range(7, dets.shape[0]):
        jstate, (jout, jmask) = jstep(jstate, jnp.asarray(dets[t]),
                                      jnp.asarray(masks[t]))
        state, (out, mask) = step(state, torch.from_numpy(dets[t]),
                                  torch.from_numpy(masks[t]))
        assert_state_equal(state, jstate)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("lap", ["jv", "auction_pallas"])
def test_runner_matches_jax_runner(lap):
    S, K, N, T = 8, 16, 8, 20
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N, n_obj=6)
    jinit, jstep = jax_make(JaxConfig(max_tracks=K, max_dets=N, lap_impl=lap))
    jrunner = JaxRunner(jinit, jstep, S, devices=jax.devices()[:1])
    init, step = make_bytetrack(
        ByteTrackConfig(max_tracks=K, max_dets=N, lap_impl=lap), device="cpu")
    runner = MultiStreamRunner(init, step, S, device="cpu")
    # two calls: the state carries across run() on both sides
    for sl in (slice(0, 12), slice(12, T)):
        jouts, jmasks = jrunner.run(dets[sl], masks[sl])
        outs, omasks = runner.run(dets[sl], masks[sl])
        assert outs.shape == (sl.stop - sl.start, S, K, 8)
        jmasks = np.asarray(jmasks)
        np.testing.assert_array_equal(omasks.numpy(), jmasks)
        got, want = outs.numpy()[jmasks], np.asarray(jouts)[jmasks]
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert jmasks.sum() > 0


def test_runner_states_set_states_and_reset():
    S, K, N, T = 4, 16, 8, 10
    dets, masks = synth_stream_dets(np.random.default_rng(2), T, S, N, n_obj=5)
    init, step = make_bytetrack(ByteTrackConfig(max_tracks=K, max_dets=N),
                                device="cpu")
    runner = MultiStreamRunner(init, step, S, device="cpu")
    assert runner.states is None
    runner.run(dets[:5], masks[:5])
    snap = runner.states
    tail, tail_m = runner.run(dets[5:], masks[5:])

    # a pure call from the snapshot leaves the carried state alone
    pure, pure_m = runner.run(dets[5:], masks[5:], states=snap)
    np.testing.assert_array_equal(pure_m.numpy(), tail_m.numpy())
    np.testing.assert_array_equal(pure.numpy(), tail.numpy())
    assert int(runner.states.frame_id[0]) == T

    runner.set_states(snap)
    again, again_m = runner.run(dets[5:], masks[5:])
    np.testing.assert_array_equal(again.numpy(), tail.numpy())

    runner.reset()
    fresh, fresh_m = runner.run(dets[:5], masks[:5])
    first, first_m = MultiStreamRunner(init, step, S, device="cpu").run(
        dets[:5], masks[:5])
    np.testing.assert_array_equal(fresh.numpy(), first.numpy())
    np.testing.assert_array_equal(fresh_m.numpy(), first_m.numpy())
    assert int(runner.init_states().next_id.sum()) == 0


def test_wrapper_matches_jax_wrapper_and_reset_restarts_ids():
    from motcpp_tpu.models.bytetrack import ByteTrack as JaxByteTrack

    dets, masks = scene(S=1, T=12, N=8, seed=3)
    img = np.zeros((480, 640, 3), np.uint8)
    tr = create_tracker("bytetrack", max_tracks=16, max_dets=8, device="cpu")
    jtr = JaxByteTrack(max_tracks=16, max_dets=8)

    def run(tracker):
        return [tracker.update(dets[t, 0][masks[t, 0]], img)
                for t in range(dets.shape[0])]

    outs = run(tr)
    for got, want in zip(outs, run(jtr)):
        assert got.shape == want.shape and got.shape[1] == 8
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert max(o[:, 4].max() for o in outs if len(o)) > 1

    tr.reset()
    again = run(tr)
    for a, b in zip(again, outs):
        np.testing.assert_array_equal(a, b)
    tr.reset()
    assert tr.update(np.zeros((0, 6), np.float32), img).shape == (0, 8)


def test_wrapper_rejects_bad_input():
    tr = create_tracker("bytetrack", max_dets=2, device="cpu")
    with pytest.raises(ValueError):
        tr.update(np.zeros((3, 6), np.float32))
    with pytest.raises(ValueError):
        tr.update(np.zeros((1, 5), np.float32))
    with pytest.raises(ValueError):
        tr.update(np.zeros((1, 6), np.float32), embs=np.zeros((2, 4)))


def test_create_tracker_names():
    """Every tracker of TRACKERS is ported (UCMCTrack also as "ucmc");
    an unknown name raises."""
    import motcpp_tpu_torch
    from motcpp_tpu_torch import models

    for name in motcpp_tpu_torch.TRACKERS + ("ucmc",):
        create_tracker(name, max_tracks=4, max_dets=2, device="cpu")
    assert set(models.registry) == set(motcpp_tpu_torch.TRACKERS) | {"ucmc"}
    with pytest.raises(ValueError, match="Unknown"):
        create_tracker("bogus", device="cpu")
