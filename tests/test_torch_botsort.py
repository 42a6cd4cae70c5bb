"""Port parity: kf_xywh, the BoT-SORT step, state hand-over, host wrapper
and the converted-checkpoint ReID chain of motcpp_tpu_torch against the
JAX package on the same seeded scenes.

Integer state, masks and ids must be identical; float state and outputs
are compared at rtol 1e-5 (atol 0, or 1e-3 px for emitted boxes), as in
tests/test_torch_bytetrack.py: the two sides do the same float32
operations, but XLA may fuse a multiply and an add into one rounding.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.models.botsort import BotSort as JaxBotSort
from motcpp_tpu.models.botsort import BotSortConfig as JaxConfig
from motcpp_tpu.models.botsort import make_botsort as jax_make
from motcpp_tpu.ops.kalman.gaussian import kf_xywh as jax_kf
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.botsort import (
    BotSortConfig,
    BotState,
    make_botsort,
    state_from_numpy,
    state_to_numpy,
)
from motcpp_tpu_torch.ops.kalman import kf_xywh

import torch_threads  # noqa: F401  (torch at one thread)

HERE = Path(__file__).resolve().parent
INT_FIELDS = ("tstate", "is_activated", "tid", "det_ind", "start_frame",
              "end_frame", "has_feat", "next_id", "frame_count")
FLOAT_FIELDS = ("mean", "cov", "conf", "cls", "feat")
D = 8


def test_kf_xywh_matches_jax():
    rng = np.random.default_rng(0)
    z = np.concatenate([rng.uniform(50, 500, (5, 2)),
                        rng.uniform(20, 200, (5, 2))], 1).astype(np.float32)
    jm, jc = jax_kf.initiate(jnp.asarray(z))
    m, c = kf_xywh.initiate(torch.from_numpy(z))
    for _ in range(3):
        jm, jc = jax_kf.predict(jm, jc)
        m, c = kf_xywh.predict(m, c)
    z2 = z + rng.normal(0, 3, z.shape).astype(np.float32)
    jm, jc = jax_kf.update(jm, jc, jnp.asarray(z2))
    m, c = kf_xywh.update(m, c, torch.from_numpy(z2))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


def scene(S=3, T=14, N=8, n_obj=6, seed=0):
    """Dets with low-confidence ones, an empty frame and a gap, unit
    embeddings per object with noise (some rows zero: no feature), and
    small translation warps (identity on even frames)."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.25
    dets[..., 4] = np.where(low, rng.uniform(0.15, 0.5, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[8:11, 0] = False  # stream 0: empty input, then lost tracks
    ident = rng.normal(size=(S, N, D))
    embs = ident[None] + 0.2 * rng.normal(size=(T, S, N, D))
    embs[rng.random((T, S, N)) < 0.1] = 0.0
    warps = np.zeros((T, S, 2, 3), np.float32)
    warps[..., 0, 0] = warps[..., 1, 1] = 1.0
    warps[1::2, :, :, 2] = rng.normal(0, 2, (T // 2, S, 2))
    return dets, masks, embs.astype(np.float32), warps


def assert_state_equal(port_state, jax_state):
    got = state_to_numpy(port_state)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jax_state, name)),
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(got[name], np.asarray(getattr(jax_state, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def jax_vstep(cfg, with_warp):
    init, step = jax_make(JaxConfig(**cfg))
    if with_warp:
        return init, jax.jit(jax.vmap(step))
    return init, jax.jit(jax.vmap(lambda s, d, m, e: step(s, d, m, e)))


@pytest.mark.parametrize("lap,with_warp", [("jv", True), ("jv", False),
                                           ("auction_pallas", True)])
def test_step_matches_jax_frame_by_frame(lap, with_warp):
    cfg = dict(max_tracks=16, max_dets=8, track_buffer=3, emb_dim=D,
               lap_impl=lap)
    dets, masks, embs, warps = scene()
    S = dets.shape[1]
    jinit, jstep = jax_vstep(cfg, with_warp)
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    init, step = make_botsort(BotSortConfig(**cfg), device="cpu")
    state = init(S)
    for t in range(dets.shape[0]):
        jargs = [jnp.asarray(a[t]) for a in (dets, masks, embs)]
        args = [torch.from_numpy(a[t]) for a in (dets, masks, embs)]
        if with_warp:
            jargs.append(jnp.asarray(warps[t]))
            args.append(torch.from_numpy(warps[t]))
        jstate, (jout, jmask) = jstep(jstate, *jargs)
        state, (out, mask) = step(state, *args)
        assert_state_equal(state, jstate)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=0)
    assert {0, 1, 2} <= set(np.unique(np.asarray(state.tstate)))
    assert bool(state.has_feat.any())


def test_state_round_trip_and_mid_sequence_handover():
    cfg = dict(max_tracks=16, max_dets=8, track_buffer=3, emb_dim=D)
    dets, masks, embs, warps = scene(seed=1)
    S = dets.shape[1]
    jinit, jstep = jax_vstep(cfg, True)
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    for t in range(7):
        jstate, _ = jstep(jstate, *(jnp.asarray(a[t]) for a in
                                    (dets, masks, embs, warps)))
    arrays = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    state = state_from_numpy(arrays, device="cpu")
    assert isinstance(state, BotState)
    back = state_to_numpy(state)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    _, step = make_botsort(BotSortConfig(**cfg), device="cpu")
    for t in range(7, dets.shape[0]):
        jstate, _ = jstep(jstate, *(jnp.asarray(a[t]) for a in
                                    (dets, masks, embs, warps)))
        state, _ = step(state, *(torch.from_numpy(a[t]) for a in
                                 (dets, masks, embs, warps)))
        assert_state_equal(state, jstate)


def test_wrapper_matches_jax_wrapper():
    """Embeddings given (the tracker rebuilds for their width), warps
    from the ECC estimator on real-looking frames, an empty frame that
    returns at once, and reset."""
    dets, masks, embs, _ = scene(S=1, T=10, seed=3)
    rng = np.random.default_rng(4)
    base = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    imgs = [np.roll(base, (t, 2 * t), (0, 1)) for t in range(dets.shape[0])]
    tr = create_tracker("botsort", max_tracks=16, max_dets=8, device="cpu")
    jtr = JaxBotSort(max_tracks=16, max_dets=8)

    def run(tracker):
        out = []
        for t in range(dets.shape[0]):
            m = masks[t, 0]
            out.append(tracker.update(dets[t, 0][m], imgs[t], embs[t, 0][m]))
        return out

    outs = run(tr)
    for got, want in zip(outs, run(jtr)):
        assert got.shape == want.shape and got.shape[1] == 8
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert tr.cfg.emb_dim == D and max(len(o) for o in outs) > 0
    assert tr.update(np.zeros((0, 6), np.float32), imgs[0]).shape == (0, 8)
    tr.reset()
    again = run(tr)
    for a, b in zip(again, outs):
        np.testing.assert_array_equal(a, b)


def test_converted_checkpoint_tracking_golden():
    """BoT-SORT over the real MOT17-02 frames with features computed
    from the pixels by the port's ReIDBackend on the committed converted
    checkpoint reproduces the golden rows, to the bar of
    tests/test_reid_fixture.py."""
    import sys

    from motcpp_tpu_torch.appearance.reid import ReIDBackend

    sys.path.insert(0, str(HERE.parent))
    from scripts.regen_golden_reid import N_FRAMES, load_frames_and_dets

    want = json.loads((HERE / "golden_reid" / "botsort_MOT17-02.json").read_text())
    backend = ReIDBackend(weights=str(HERE / "fixtures" /
                                      "osnet_x0_25_converted.npz"),
                          device="cpu")
    frames, dets_by_frame = load_frames_and_dets()
    tr = create_tracker("botsort", max_tracks=64, max_dets=32, device="cpu")
    got = []
    for t in range(1, N_FRAMES + 1):
        dets = dets_by_frame.get(t, np.zeros((0, 6), np.float32))
        out = tr.update(dets, frames[t], backend.get_features(dets[:, :4],
                                                              frames[t]))
        got += [[t] + [round(float(v), 2) for v in r] for r in out]
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[5] == w[5], (g, w)  # frame and id exact
        np.testing.assert_allclose(g[1:5], w[1:5], atol=0.05)
        np.testing.assert_allclose(g[6:], w[6:], atol=0.05)


def test_wrapper_computes_features_from_reid_weights():
    """With reid_weights and no embeddings, the wrapper embeds the
    detections from the image: the same tracks as feeding the backend's
    features by hand."""
    from motcpp_tpu_torch.appearance.reid import ReIDBackend

    weights = str(HERE / "fixtures" / "osnet_x0_25_converted.npz")
    dets, masks, _, _ = scene(S=1, T=4, seed=5)
    img = np.random.default_rng(6).integers(0, 255, (1080, 1920, 3)).astype(np.uint8)
    live = create_tracker("botsort", reid_weights=weights, max_tracks=16,
                          max_dets=8, cmc_method="none", device="cpu")
    fed = create_tracker("botsort", max_tracks=16, max_dets=8,
                         cmc_method="none", device="cpu")
    backend = ReIDBackend(weights, device="cpu")
    for t in range(dets.shape[0]):
        d = dets[t, 0][masks[t, 0]]
        a = live.update(d, img)
        b = fed.update(d, img, backend.get_features(d[:, :4], img))
        np.testing.assert_array_equal(a, b)
    assert live.cfg.emb_dim == 512
