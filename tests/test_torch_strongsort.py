"""Port parity: NSA Kalman and gating, the StrongSORT step, its host
wrapper and ReID chain, the eval CLI, the host ECC, the embedding
priority and the priority-budget live-ReID runner of motcpp_tpu_torch
against the JAX package on the same seeded inputs and the goldens it
pins.

Integer state, masks and ids must be identical; float state and outputs
are compared at rtol 1e-5, atol 0 (or the atol a test states), as in
tests/test_torch_bytetrack.py. The live-ReID rollout runs OSNet x0_25 on
32x16 crops, every OSBlock through ``osblock_fused`` (the Pallas kernel
in interpret mode on the JAX side, its plain version on the CPU on the
port's side), with the flax weights carried across.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.appearance.osnet import init_params as jax_init
from motcpp_tpu.appearance.osnet import osnet_x0_25 as jax_osnet
from motcpp_tpu.appearance.reid import make_embed_fn as jax_embed_fn
from motcpp_tpu.models.strongsort import StrongSORT as JaxStrongSORT
from motcpp_tpu.models.strongsort import StrongSortConfig as JaxConfig
from motcpp_tpu.models.strongsort import make_strongsort as jax_make
from motcpp_tpu.ops.kalman.gaussian import kf_xyah as jax_kf
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu.parallel.streams import embedding_priority as jax_priority
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.appearance.osnet import infer_osnet, state_dict_from_flax
from motcpp_tpu_torch.appearance.reid import ReIDBackend, make_embed_fn
from motcpp_tpu_torch.cli import build_tracker
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.strongsort import StrongSortConfig, make_strongsort
from motcpp_tpu_torch.ops.kalman import kf_xyah
from motcpp_tpu_torch.parallel.streams import (
    MultiStreamRunner,
    embedding_priority,
)
from test_torch_golden import check_goldens

import torch_threads  # noqa: F401  (torch at one thread)

HERE = Path(__file__).resolve().parent
WEIGHTS = HERE / "fixtures" / "osnet_x0_25_converted.npz"
INT_FIELDS = ("sstate", "tid", "det_ind", "hits", "age", "tsu", "has_feat",
              "gallery_count", "next_id", "frame_count")
FLOAT_FIELDS = ("mean", "cov", "conf", "cls", "feat", "gallery")
D = 8


def kf_inputs(rng, n=6):
    z = np.concatenate([rng.uniform(50, 500, (n, 2)),
                        rng.uniform(0.3, 0.7, (n, 1)),
                        rng.uniform(40, 200, (n, 1))], 1).astype(np.float32)
    conf = rng.uniform(0.3, 0.95, n).astype(np.float32)
    meas = (z[None] + rng.normal(0, [4, 4, 0.02, 4], (3, n, 4))
            ).astype(np.float32).transpose(1, 0, 2)  # (n, 3, 4)
    return z, conf, meas


def test_kf_xyah_nsa_project_update_and_gating_match_jax():
    rng = np.random.default_rng(0)
    z, conf, meas = kf_inputs(rng)
    jm, jc = jax_kf.initiate(jnp.asarray(z))
    m, c = kf_xyah.initiate(torch.from_numpy(z))
    for _ in range(2):
        jm, jc = jax_kf.predict(jm, jc)
        m, c = kf_xyah.predict(m, c)
    for nsa in (0.0, conf):
        jn = nsa if isinstance(nsa, float) else jnp.asarray(nsa)
        tn = nsa if isinstance(nsa, float) else torch.from_numpy(nsa)
        for got, want in zip(kf_xyah.project(m, c, tn),
                             jax_kf.project(jm, jc, jn)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=0)
        for only_position in (False, True):
            got = kf_xyah.gating_distance(m, c, torch.from_numpy(meas),
                                          only_position, tn)
            want = jax_kf.gating_distance(jm, jc, jnp.asarray(meas),
                                          only_position, jn)
            assert got.shape == (6, 3)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=0)
        z2 = meas[:, 0]
        gm, gc = kf_xyah.update(m, c, torch.from_numpy(z2), tn)
        wm, wc = jax_kf.update(jm, jc, jnp.asarray(z2), jn)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-5,
                                   atol=0)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                                   atol=0)
    # the confidence scaling changes the update: it is applied
    plain = kf_xyah.update(m, c, torch.from_numpy(z2))[1]
    assert not torch.allclose(gc, plain)


def scene(S=3, T=16, N=8, n_obj=6, seed=0):
    """Dets (some below min_conf), a gap long enough to age tracks out,
    unit embeddings per object with noise (some rows zero: no feature)
    and small translation warps (identity on even frames)."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.1
    dets[..., 4] = np.where(low, rng.uniform(0.02, 0.09, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[7:12, 0] = False
    ident = rng.normal(size=(S, N, D))
    embs = ident[None] + 0.2 * rng.normal(size=(T, S, N, D))
    embs[rng.random((T, S, N)) < 0.1] = 0.0
    warps = np.zeros((T, S, 2, 3), np.float32)
    warps[..., 0, 0] = warps[..., 1, 1] = 1.0
    warps[1::2, :, :, 2] = rng.normal(0, 2, (T // 2, S, 2))
    return dets, masks, embs.astype(np.float32), warps


def assert_state_equal(state, jstate):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("lap,with_warp", [("jv", True), ("jv", False),
                                           ("auction_pallas", True)])
def test_step_matches_jax_frame_by_frame(lap, with_warp):
    """atol 1e-6 on float state, as tests/test_torch_botsort.py: the
    unit features' components and the covariance's cross terms sit near
    zero, where a last-bit difference is not relative."""
    cfg = dict(max_tracks=16, max_dets=8, max_age=3, n_init=2,
               gallery_cap=4, emb_dim=D, lap_impl=lap)
    dets, masks, embs, warps = scene()
    S = dets.shape[1]
    jinit, jstep = jax_make(JaxConfig(**cfg))
    if not with_warp:
        jstep = (lambda f: lambda s, d, m, e: f(s, d, m, e))(jstep)
    jstep = jax.jit(jax.vmap(jstep))
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    init, step = make_strongsort(StrongSortConfig(**cfg), device="cpu")
    state = init(S)
    seen = set()
    for t in range(dets.shape[0]):
        arrays = (dets, masks, embs) + ((warps,) if with_warp else ())
        jstate, (jout, jmask) = jstep(jstate, *(jnp.asarray(a[t])
                                                for a in arrays))
        state, (out, mask) = step(state, *(torch.from_numpy(a[t])
                                           for a in arrays))
        assert_state_equal(state, jstate)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=0)
        seen.update(np.unique(state.sstate.numpy()).tolist())
    assert seen == {0, 1, 2}
    assert int(state.gallery_count.max()) > 4  # the ring wrapped


def test_wrapper_matches_jax_wrapper():
    """Embeddings given (the tracker rebuilds for their width), warps
    from the host ECC on textured frames, and reset."""
    dets, masks, embs, _ = scene(S=1, T=10, seed=3)
    rng = np.random.default_rng(4)
    base = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    imgs = [np.roll(base, (t, 2 * t), (0, 1)) for t in range(dets.shape[0])]
    tr = create_tracker("strongsort", max_tracks=16, max_dets=8, n_init=2,
                        device="cpu")
    jtr = JaxStrongSORT(max_tracks=16, max_dets=8, n_init=2)

    def run(tracker):
        out = []
        for t in range(dets.shape[0]):
            m = masks[t, 0]
            out.append(np.asarray(tracker.update(dets[t, 0][m], imgs[t],
                                                 embs[t, 0][m])))
        return out

    outs = run(tr)
    for got, want in zip(outs, run(jtr)):
        assert got.shape == want.shape and got.shape[1] == 8
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert tr.cfg.emb_dim == D and max(len(o) for o in outs) > 0
    tr.reset()
    for a, b in zip(run(tr), outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["golden", "golden_long"])
def test_port_cli_writes_strongsort_goldens(which, tmp_path):
    check_goldens("strongsort", which, tmp_path)


def test_converted_checkpoint_tracking_golden():
    """StrongSORT over the real MOT17-02 frames with features computed
    from the pixels by the port's ReIDBackend on the committed converted
    checkpoint reproduces the golden rows, to the bar of
    tests/test_reid_fixture.py."""
    sys.path.insert(0, str(HERE.parent))
    from scripts.regen_golden_reid import N_FRAMES, load_frames_and_dets

    want = json.loads((HERE / "golden_reid" / "strongsort_MOT17-02.json")
                      .read_text())
    backend = ReIDBackend(weights=str(WEIGHTS), device="cpu")
    frames, dets_by_frame = load_frames_and_dets()
    tr = create_tracker("strongsort", max_tracks=64, max_dets=32, device="cpu")
    got = []
    for t in range(1, N_FRAMES + 1):
        dets = dets_by_frame.get(t, np.zeros((0, 6), np.float32))
        out = tr.update(dets, frames[t], backend.get_features(dets[:, :4],
                                                              frames[t]))
        got += [[t] + [round(float(v), 2) for v in r] for r in out]
    assert len(got) == len(want) > 0, (len(got), len(want))
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[5] == w[5], (g, w)  # frame and id exact
        np.testing.assert_allclose(g[1:5], w[1:5], atol=0.05)
        np.testing.assert_allclose(g[6:], w[6:], atol=0.05)


def test_ecc_golden_on_the_camera_pan_scene():
    """tests/golden_cmc/strongsort_ecc.txt, byte for byte, with the
    port's host ECC estimating the warps from the frames."""
    cv2 = pytest.importorskip("cv2")
    sys.path.insert(0, str(HERE.parent / "scripts"))
    from motcpp_tpu.data.synthetic import camera_pan_scene
    from motcpp_tpu_torch.data import convert_to_mot_format
    from regen_golden_cmc import DROPOUTS

    cv2.setRNGSeed(0)
    frames, dets_all, embs_all = camera_pan_scene(n_frames=30,
                                                  dropout_frames=DROPOUTS)
    tr = create_tracker("strongsort", max_dets=16, max_tracks=32, device="cpu")
    lines = []
    for t, (img, dets, embs) in enumerate(zip(frames, dets_all, embs_all)):
        for row in convert_to_mot_format(tr.update(dets, img, embs), t + 1):
            lines.append(",".join([f"{int(v)}" for v in row[:6]]
                                  + [f"{row[6]:.6f}", "-1", "-1", "-1"]))
    want = (HERE / "golden_cmc" / "strongsort_ecc.txt").read_text()
    assert "\n".join(lines) + "\n" == want


def test_build_tracker_gives_strongsort_its_reid_weights():
    """StrongSORT takes reid_weights from the CLI and no with_reid switch
    (JAX cli.py:48-51)."""
    tr = build_tracker("strongsort", reid_weights=str(WEIGHTS), device="cpu")
    assert tr.reid_weights == str(WEIGHTS)
    bot = build_tracker("botsort", reid_weights=str(WEIGHTS), device="cpu")
    assert bot.cfg.with_reid and bot.reid_weights == str(WEIGHTS)


def priority_dets(rng, S=3, N=6):
    """Boxes whose corner cells overflow the int32 tie term (x up to
    4000 px: cells past 24) or are negative (boxes past the left and
    top edges), some masked."""
    x1 = rng.uniform(-900, 4000, (S, N))
    y1 = rng.uniform(-600, 2000, (S, N))
    wh = rng.uniform(20, 200, (S, N, 2))
    d = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1],
                  rng.uniform(0.3, 1, (S, N)), np.zeros((S, N))], -1)
    return d.astype(np.float32), rng.random((S, N)) < 0.8


@pytest.mark.parametrize("rot", [8, 4])
@pytest.mark.parametrize("t", [0, 5, 7, 123456])
def test_embedding_priority_matches_jax(t, rot):
    rng = np.random.default_rng(t)
    d, m = priority_dets(rng)
    pd, pm = priority_dets(rng)
    pd[0, :3] = d[0, :3] + 2.0  # near-repeats of the previous frame
    pm[2] = False  # a stream without previous observations
    cells = np.round(d[..., 0] / 40.0) + np.round(d[..., 1] / 40.0)
    assert cells.max() > 24 and cells.min() < 0
    got = embedding_priority(*(torch.from_numpy(a) for a in (d, m, pd, pm)),
                             t, rot=rot)
    want = jax_priority(*(jnp.asarray(a) for a in (d, m, pd, pm)),
                        jnp.int32(t), rot=rot)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# live ReID: T frames of S streams, N det slots, 32x16 crops, D features
LT, LS, LN, HW, LD = 4, 4, 8, (32, 16), 32
LIVE_CFG = dict(emb_dim=LD, max_tracks=16, max_dets=LN, n_init=1,
                gallery_cap=16)


@pytest.fixture(scope="module")
def live_scene():
    """Flax variables, the port's OSNet with the same weights, and a
    seeded scene: four objects in each stream (at most 16 valid crops a
    frame) plus a fifth in stream 0 from frame 2 (17)."""
    jmodel = jax_osnet(feature_dim=LD)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = state_dict_from_flax(variables)
    model = infer_osnet(sd)
    model.load_state_dict(sd)
    rng = np.random.default_rng(5)
    dets, masks = synth_stream_dets(rng, LT, LS, LN, n_obj=5)
    masks[:, 1:, 4] = False
    masks[:2, 0, 4] = False
    crops = rng.integers(0, 255, (LT, LS, LN) + HW + (3,)).astype(np.uint8)
    return jmodel, variables, model, dets, masks, crops


def port_live_runner(live_scene, budget, rot=8):
    init, step = make_strongsort(StrongSortConfig(**LIVE_CFG), device="cpu")
    return MultiStreamRunner(init, step, LS, device="cpu",
                             embed_fn=make_embed_fn(live_scene[2], fused=True,
                                                    device="cpu"),
                             crop_budget=budget, emb_priority=True,
                             priority_rot=rot)


@pytest.mark.parametrize("budget,rot",
                         [(round(0.6 * LS * LN), 8), (12, 8), (12, 4)],
                         ids=["deployed_0.6", "below_valid", "below_valid_rot4"])
def test_priority_budget_live_reid_rollout_matches_jax(live_scene, budget,
                                                        rot):
    """At 0.6 of S*N (bench.py's deployed point: the budget covers every
    valid crop and the priority only orders them) and at a budget below
    the valid count, where the priority chooses the crops, there also
    with a refresh rotation of 4 frames."""
    jmodel, variables, _, dets, masks, crops = live_scene
    assert (int(masks.sum((1, 2)).max()) <= round(0.6 * LS * LN)
            and int(masks.sum((1, 2)).min()) > 12)
    init, step = jax_make(JaxConfig(**LIVE_CFG))
    jrunner = JaxRunner(init, step, LS, devices=jax.devices()[:1],
                        embed_fn=jax_embed_fn(jmodel, variables, fused=True),
                        crop_budget=budget, emb_priority=True,
                        priority_rot=rot)
    want = jrunner.run(jnp.asarray(dets), jnp.asarray(masks),
                       embs=jnp.asarray(crops))
    got = port_live_runner(live_scene, budget, rot).run(dets, masks,
                                                        embs=crops)
    (go, gm), (wo, wm) = got, (np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert int(wm.sum()) > 0
    np.testing.assert_array_equal(go[..., 4].numpy()[wm], wo[..., 4][wm])
    np.testing.assert_allclose(go.numpy()[wm], wo[wm], atol=1e-4, rtol=0)


def test_priority_carry_across_runs_and_pure_calls(live_scene):
    """T=1 run() calls continue one run of T frames (the previous frame's
    detections and the phase carry); a pure call with states= starts
    from frame0 with everything novel and leaves the carry alone; reset()
    clears it."""
    dets, masks, crops = live_scene[3:]
    whole = port_live_runner(live_scene, 12).run(dets, masks, embs=crops)
    r = port_live_runner(live_scene, 12)
    parts = [r.run(dets[:1], masks[:1], embs=crops[:1])]
    states = r.states
    prev = r._prev_dets
    parts += [r.run(dets[t:t + 1], masks[t:t + 1], embs=crops[t:t + 1])
              for t in range(1, LT)]
    for i in range(2):
        assert torch.equal(whole[i], torch.cat([p[i] for p in parts]))
    assert r._frame0 == LT and torch.equal(r._prev_dets[0],
                                           torch.from_numpy(dets[-1]))
    # pure from the snapshot after frame 0: frame 1 sees no previous
    # detections there, so it is the same as a fresh runner's
    # continuation only from frame 2 on; it must not touch the carry
    carried = r._prev_dets
    pure = r.run(dets[1:], masks[1:], embs=crops[1:], states=states, frame0=1)
    assert r._prev_dets is carried and r._frame0 == LT
    again = port_live_runner(live_scene, 12)
    again.set_states(states, frame0=1)
    ref = again.run(dets[1:], masks[1:], embs=crops[1:])
    assert torch.equal(pure[1], ref[1]) and torch.equal(pure[0], ref[0])
    assert prev is not None
    r.reset()
    assert r._prev_dets is None and r._frame0 == 0
    fresh = r.run(dets, masks, embs=crops)
    assert torch.equal(fresh[1], whole[1]) and torch.equal(fresh[0], whole[0])
