"""Port parity: BoostTrack's Kalman helpers, its step, host wrapper, the
eval CLI, the host ECC golden and the multi-stream runner (motion-only
and live ReID at bench.py's deployed cadence) of motcpp_tpu_torch
against the JAX package on the same seeded inputs and the goldens it
pins.

Integer state, masks and ids must be identical. Float state is compared
at rtol 1e-5 with the atol each field states in ``FLOAT_ATOL``, outputs
at rtol 1e-5, atol 0; boxes emitted by the runners agree to 1e-3 px
(1e-4 px under live ReID, as tests/test_torch_live_reid.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.appearance.osnet import init_params as jax_init
from motcpp_tpu.appearance.osnet import osnet_x0_25 as jax_osnet
from motcpp_tpu.appearance.reid import make_embed_fn as jax_embed_fn
from motcpp_tpu.models import boosttrack as jbt
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.appearance.osnet import infer_osnet, state_dict_from_flax
from motcpp_tpu_torch.appearance.reid import make_embed_fn
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models import boosttrack as bt
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from test_torch_golden import check_goldens

import torch_threads  # noqa: F401  (torch at one thread)

HERE = Path(__file__).resolve().parent
INT_FIELDS = ("active", "tid", "det_ind", "age", "tsu", "hit_streak",
              "has_emb", "next_id", "frame_count")
# emb: unit vectors' components near zero
FLOAT_ATOL = {"x": 0, "P": 0, "conf": 0, "cls": 0, "emb": 1e-6}
# under a warp that rotates and scales, XLA evaluates the corners' 3-term
# products as fused multiply-adds, which PyTorch rounds separately: the
# aspect ratio and its velocity (order 0.1 to 1) differ by up to 1e-4
AFFINE_X_ATOL = 2e-4
D = 8


def kf_inputs(rng, n=6):
    xyxy = np.concatenate([rng.uniform(0, 500, (n, 2)), np.zeros((n, 2))], 1)
    xyxy[:, 2:] = xyxy[:, :2] + rng.uniform(10, 200, (n, 2))
    xyxy[0, 3] = xyxy[0, 1]  # zero height: r = 0
    z = np.asarray(jbt._bbox_to_z(jnp.asarray(xyxy, jnp.float32)))
    x = np.concatenate([z, rng.normal(0, 2, (n, 4))], 1).astype(np.float32)
    A = rng.normal(size=(n, 8, 8))
    P = (A @ A.transpose(0, 2, 1) + np.diag(jbt._P0.diagonal())).astype(
        np.float32)
    z = (x[:, :4] + rng.normal(0, 3, (n, 4))).astype(np.float32)
    return xyxy.astype(np.float32), x, P, z


def test_kalman_helpers_match_jax():
    xyxy, x, P, z = kf_inputs(np.random.default_rng(0))
    t = torch.from_numpy
    for got, want in [
        (bt._bbox_to_z(t(xyxy)), jbt._bbox_to_z(jnp.asarray(xyxy))),
        (bt._z_to_bbox(t(x)), jbt._z_to_bbox(jnp.asarray(x))),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)
    Q = torch.diag(torch.tensor(bt._Q_DIAG))
    R = torch.diag(torch.tensor(bt._R_DIAG))
    for got, want in zip(bt._kf_predict(t(x), t(P), Q),
                         jbt._kf_predict(jnp.asarray(x), jnp.asarray(P))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(bt._kf_update(t(x), t(P), t(z), R),
                         jbt._kf_update(jnp.asarray(x), jnp.asarray(P),
                                        jnp.asarray(z))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-3)


def scene(S=4, T=18, N=8, n_obj=6, seed=0):
    """synth_stream_dets with dets around det_thresh (the boosts lift
    some of them), gaps long enough for deaths, unit embeddings per
    object with noise (some rows zero), and warps: a small rotation,
    scale and translation on odd frames, the identity on even ones."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.3
    dets[..., 4] = np.where(low, rng.uniform(0.3, 0.6, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[6:9, 0, :3] = False
    masks[9:15, -1] = False
    ident = rng.normal(size=(S, N, D))
    embs = ident[None] + 0.3 * rng.normal(size=(T, S, N, D))
    embs[rng.random((T, S, N)) < 0.1] = 0.0
    warps = np.zeros((T, S, 2, 3), np.float32)
    warps[..., 0, 0] = warps[..., 1, 1] = 1.0
    a = rng.uniform(-0.01, 0.01, (T // 2, S))
    sc = rng.uniform(0.99, 1.01, (T // 2, S))
    warps[1::2, :, 0, 0] = warps[1::2, :, 1, 1] = sc * np.cos(a)
    warps[1::2, :, 0, 1] = -sc * np.sin(a)
    warps[1::2, :, 1, 0] = sc * np.sin(a)
    warps[1::2, :, :, 2] = rng.normal(0, 3, (T // 2, S, 2))
    return dets, masks, embs.astype(np.float32), warps


def assert_state_equal(state, jstate, atols):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    for name, atol in atols.items():
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("lap,with_reid,warp,boost", [
    ("jv", True, "affine", "dlo"), ("jv", True, "none", "sb_vt"),
    ("jv", False, "identity", "dlo"), ("auction_pallas", True, "affine", "sb"),
])
def test_step_matches_jax_frame_by_frame(lap, with_reid, warp, boost):
    cfg = dict(max_tracks=16, max_dets=8, max_age=4, min_hits=2, emb_dim=D,
               lap_impl=lap, with_reid=with_reid, use_sb="sb" in boost,
               use_vt="vt" in boost)
    dets, masks, embs, warps = scene()
    if warp == "identity":
        warps[:] = np.eye(2, 3, dtype=np.float32)
    S = dets.shape[1]
    jinit, jcore = jbt.make_boosttrack(jbt.BoostTrackConfig(**cfg))
    jstep = jax.jit(jax.vmap(
        lambda s, d, m, e, w: jcore(s, d, m, e,
                                    None if warp == "none" else w)))
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    init, step = bt.make_boosttrack(bt.BoostTrackConfig(**cfg), device="cpu")
    state = init(S)
    for t in range(dets.shape[0]):
        jstate, (jout, jmask) = jstep(jstate, *(jnp.asarray(a[t]) for a in
                                                (dets, masks, embs, warps)))
        d, m, e, w = (torch.from_numpy(a[t]) for a in (dets, masks, embs,
                                                       warps))
        state, (out, mask) = step(state, d, m, e,
                                  None if warp == "none" else w)
        assert_state_equal(state, jstate, dict(
            FLOAT_ATOL, x=AFFINE_X_ATOL if warp == "affine" else 0))
        jmask = np.asarray(jmask)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        np.testing.assert_allclose(out.numpy()[jmask], np.asarray(jout)[jmask],
                                   rtol=1e-5, atol=0)
    assert int(state.next_id.max()) > 6  # deaths and rebirths happened


def test_wrapper_matches_jax_wrapper():
    """Embeddings given (the tracker rebuilds for their width) with
    with_reid, warps injected, and reset."""
    dets, masks, embs, warps = scene(S=1, T=12, seed=3)
    kw = dict(max_tracks=16, max_dets=8, with_reid=True)
    tr = create_tracker("boosttrack", device="cpu", **kw)
    jtr = jbt.BoostTrack(**kw)

    def run(tracker):
        out = []
        for t in range(dets.shape[0]):
            m = masks[t, 0]
            out.append(np.asarray(tracker.update(dets[t, 0][m], None,
                                                 embs[t, 0][m],
                                                 warp=warps[t, 0])))
        return out

    outs = run(tr)
    for got, want in zip(outs, run(jtr)):
        assert got.shape == want.shape and got.shape[1] == 8
        np.testing.assert_array_equal(got[:, [4, 6, 7]], want[:, [4, 6, 7]])
        # the boosted confidence follows the IoU under the rotating warp
        np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert tr.cfg.emb_dim == D and sum(len(o) for o in outs) > 0
    tr.reset()
    for a, b in zip(run(tr), outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["golden", "golden_long"])
def test_port_cli_writes_boosttrack_goldens(which, tmp_path):
    check_goldens("boosttrack", which, tmp_path)


def test_ecc_golden_on_the_camera_pan_scene():
    """tests/golden_cmc/boosttrack_ecc.txt, byte for byte, with the
    port's host ECC estimating the warps from the frames."""
    pytest.importorskip("cv2")
    from test_torch_cmc import golden_cmc_lines

    assert golden_cmc_lines("boosttrack") == (
        HERE / "golden_cmc" / "boosttrack_ecc.txt").read_text()


@pytest.mark.parametrize("lap", ["jv", "auction_pallas"])
def test_runner_at_bench_config_matches_jax_runner(lap):
    """bench.py's BoostTrack config (min_hits=1; bench.py:116-121): no
    embeddings, no warps."""
    S, K, N, T = 8, 16, 8, 20
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N, n_obj=6)
    cfg = dict(min_hits=1, max_tracks=K, max_dets=N, lap_impl=lap)
    jinit, jstep = jbt.make_boosttrack(jbt.BoostTrackConfig(**cfg))
    jrunner = JaxRunner(jinit, jstep, S, devices=jax.devices()[:1])
    init, step = bt.make_boosttrack(bt.BoostTrackConfig(**cfg), device="cpu")
    runner = MultiStreamRunner(init, step, S, device="cpu")
    for sl in (slice(0, 12), slice(12, T)):
        jouts, jmasks = jrunner.run(dets[sl], masks[sl])
        outs, omasks = runner.run(dets[sl], masks[sl])
        jmasks = np.asarray(jmasks)
        np.testing.assert_array_equal(omasks.numpy(), jmasks)
        got, want = outs.numpy()[jmasks], np.asarray(jouts)[jmasks]
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert jmasks.sum() > 0


# live ReID: T frames of S streams, N det slots, 32x16 crops, LD features
LT, LS, LN, HW, LD = 4, 4, 6, (32, 16), 32


def test_live_reid_rollout_at_the_deployed_cadence_matches_jax():
    """bench.py's DEPLOYED point for BoostTrack (--emb-cadence 2, with
    bench_livereid's with_reid and min_hits=1): OSNet x0_25 with the flax
    weights carried across, every OSBlock through osblock_fused."""
    jmodel = jax_osnet(feature_dim=LD)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = state_dict_from_flax(variables)
    model = infer_osnet(sd)
    model.load_state_dict(sd)
    rng = np.random.default_rng(5)
    dets, masks = synth_stream_dets(rng, LT, LS, LN, n_obj=4)
    crops = rng.integers(0, 255, (LT, LS, LN) + HW + (3,)).astype(np.uint8)
    cfg = dict(min_hits=1, with_reid=True, emb_dim=LD, max_tracks=16,
               max_dets=LN)
    jinit, jstep = jbt.make_boosttrack(jbt.BoostTrackConfig(**cfg))
    jrunner = JaxRunner(jinit, jstep, LS, devices=jax.devices()[:1],
                        embed_fn=jax_embed_fn(jmodel, variables, fused=True),
                        emb_cadence=2)
    wo, wm = (np.asarray(a) for a in jrunner.run(
        jnp.asarray(dets), jnp.asarray(masks), embs=jnp.asarray(crops)))
    init, step = bt.make_boosttrack(bt.BoostTrackConfig(**cfg), device="cpu")
    runner = MultiStreamRunner(init, step, LS, device="cpu",
                               embed_fn=make_embed_fn(model, fused=True,
                                                      device="cpu"),
                               emb_cadence=2)
    go, gm = runner.run(dets, masks, embs=crops)
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert int(wm.sum()) > 0
    np.testing.assert_array_equal(go[..., 4].numpy()[wm], wo[..., 4][wm])
    np.testing.assert_allclose(go.numpy()[wm], wo[wm], atol=1e-4, rtol=0)
