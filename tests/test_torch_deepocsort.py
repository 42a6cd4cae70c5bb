"""Port parity: the adaptive embedding weight, the DeepOC-SORT step, its
host wrapper, the eval CLI, the host sparse-flow CMC golden and the
multi-stream runner (motion-only and live ReID at bench.py's deployed
cadence) of motcpp_tpu_torch against the JAX package on the same seeded
inputs and the goldens it pins.

Integer state, masks and ids must be identical. Float state is compared
at rtol 1e-5 with the atol each field states in ``FLOAT_ATOL`` and
outputs at rtol 1e-5, atol 0, as in tests/test_torch_ocsort.py; boxes
emitted by the runners agree to 1e-3 px (1e-4 px under live ReID, as
tests/test_torch_live_reid.py).
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
from motcpp_tpu.models.deepocsort import DeepOCSort as JaxDeepOCSort
from motcpp_tpu.models.deepocsort import DeepOCSortConfig as JaxConfig
from motcpp_tpu.models.deepocsort import compute_aw_max_metric as jax_aw
from motcpp_tpu.models.deepocsort import make_deepocsort as jax_make
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.appearance.osnet import infer_osnet, state_dict_from_flax
from motcpp_tpu_torch.appearance.reid import make_embed_fn
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.deepocsort import (
    DeepOCSortConfig,
    compute_aw_max_metric,
    make_deepocsort,
)
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from test_torch_golden import check_goldens

import torch_threads  # noqa: F401  (torch at one thread)

HERE = Path(__file__).resolve().parent
INT_FIELDS = ("active", "tid", "age", "hits", "hit_streak", "tsu", "det_ind",
              "obs_age", "obs_ptr", "next_id", "frame_count")
# x: the near-zero scale innovation of constant-size objects, which XLA
# rounds as one fused multiply-add (tests/test_torch_ocsort.py); emb:
# unit vectors' components near zero
FLOAT_ATOL = {"x": 2e-3, "P": 0, "conf": 0, "cls": 0, "last_obs": 0,
              "velocity": 1e-6, "obs_ring": 0, "emb": 1e-6}
# under a warp that rotates and scales, XLA evaluates each 2x2 product of
# the warp (state and covariance blocks) as a fused multiply-add, which
# PyTorch rounds twice; the Kalman update's cancellations carry the
# difference into the covariance, whose entries are within 1e-3 of the
# JAX package's (values of order 1 to 1e3) over 18 frames
AFFINE_P_ATOL = 1e-3
D = 8


def aw_cases():
    """Masks with full rows and columns, a line with one candidate, an
    empty problem, and ties (a zero maximum, an exact second)."""
    rng = np.random.default_rng(0)
    cost = rng.uniform(-0.2, 1.0, (4, 5, 6)).astype(np.float32)
    rows = rng.random((4, 5)) < 0.7
    cols = rng.random((4, 6)) < 0.7
    rows[1] = [True, False, False, False, False]
    cols[2] = False
    cost[3, 0, :] = 0.0
    cost[3, 1, 2] = cost[3, 1, 4]
    rows[3] = cols[3, :5] = True
    return cost, rows, cols


@pytest.mark.parametrize("bottom", [0.5, 0.0])
def test_compute_aw_max_metric_matches_jax(bottom):
    cost, rows, cols = aw_cases()
    got = compute_aw_max_metric(*(torch.from_numpy(a)
                                  for a in (cost, rows, cols)), 0.5, bottom)
    want = jax.vmap(lambda c, r, k: jax_aw(c, r, k, 0.5, bottom))(
        jnp.asarray(cost), jnp.asarray(rows), jnp.asarray(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def scene(S=4, T=18, N=8, n_obj=6, seed=0):
    """synth_stream_dets with some dets below det_thresh, gaps long
    enough for the OCR rematch and deaths, unit embeddings per object
    with noise (some rows zero), and warps: a small rotation, scale and
    translation on odd frames, the identity on even ones."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.15
    dets[..., 4] = np.where(low, rng.uniform(0.1, 0.29, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[6:9, 0, :3] = False
    masks[9:15, -1] = False
    ident = rng.normal(size=(S, N, D))
    embs = ident[None] + 0.3 * rng.normal(size=(T, S, N, D))
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
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


def assert_state_equal(state, jstate, atols=FLOAT_ATOL):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    for name, atol in atols.items():
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("lap,with_embs,warp", [
    ("jv", True, "affine"), ("jv", True, "none"), ("jv", False, "identity"),
    ("auction_pallas", True, "affine"),
])
def test_step_matches_jax_frame_by_frame(lap, with_embs, warp):
    cfg = dict(max_tracks=16, max_dets=8, max_age=4, min_hits=2, emb_dim=D,
               lap_impl=lap)
    dets, masks, embs, warps = scene()
    if warp == "identity":
        warps[:] = np.eye(2, 3, dtype=np.float32)
    S = dets.shape[1]
    jinit, jcore = jax_make(JaxConfig(**cfg))
    jstep = jax.jit(jax.vmap(
        lambda s, d, m, e, w: jcore(s, d, m, e if with_embs else None,
                                    None if warp == "none" else w)))
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    init, step = make_deepocsort(DeepOCSortConfig(**cfg), device="cpu")
    state = init(S)
    for t in range(dets.shape[0]):
        jstate, (jout, jmask) = jstep(jstate, *(jnp.asarray(a[t]) for a in
                                                (dets, masks, embs, warps)))
        d, m, e, w = (torch.from_numpy(a[t]) for a in (dets, masks, embs,
                                                       warps))
        state, (out, mask) = step(state, d, m, e if with_embs else None,
                                  None if warp == "none" else w)
        assert_state_equal(state, jstate, dict(
            FLOAT_ATOL, P=AFFINE_P_ATOL if warp == "affine" else 0))
        jmask = np.asarray(jmask)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        np.testing.assert_allclose(out.numpy()[jmask], np.asarray(jout)[jmask],
                                   rtol=1e-5, atol=0)
    assert int(state.next_id.max()) > 6  # deaths and rebirths happened
    assert int((state.obs_ptr > 5).sum()) > 0  # the ring wrapped


def test_wrapper_matches_jax_wrapper():
    """Embeddings given (the tracker rebuilds for their width), the
    aw_off cost, warps injected, and reset."""
    dets, masks, embs, warps = scene(S=1, T=12, seed=3)
    kw = dict(max_tracks=16, max_dets=8, aw_off=True)
    tr = create_tracker("deepocsort", device="cpu", **kw)
    jtr = JaxDeepOCSort(**kw)

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
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert tr.cfg.emb_dim == D and sum(len(o) for o in outs) > 0
    tr.reset()
    for a, b in zip(run(tr), outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["golden", "golden_long"])
def test_port_cli_writes_deepocsort_goldens(which, tmp_path):
    check_goldens("deepocsort", which, tmp_path)


def test_sof_golden_on_the_camera_pan_scene():
    """tests/golden_cmc/deepocsort_sof.txt, byte for byte, with the
    port's host SOF (OpenCV) estimating the warps from the frames."""
    pytest.importorskip("cv2")
    from motcpp_tpu_torch.scripts.regen_golden_cmc import run_scene

    assert run_scene("deepocsort", {}, device="cpu") == (
        HERE / "golden_cmc" / "deepocsort_sof.txt").read_text()


@pytest.mark.parametrize("lap", ["jv", "auction_pallas"])
def test_runner_at_bench_config_matches_jax_runner(lap):
    """bench.py's DeepOC-SORT config (min_hits=1, embedding_off,
    cmc_off; bench.py:98-103): no embeddings, no warps."""
    S, K, N, T = 8, 16, 8, 20
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N, n_obj=6)
    cfg = dict(min_hits=1, embedding_off=True, cmc_off=True, max_tracks=K,
               max_dets=N, lap_impl=lap)
    jinit, jstep = jax_make(JaxConfig(**cfg))
    jrunner = JaxRunner(jinit, jstep, S, devices=jax.devices()[:1])
    init, step = make_deepocsort(DeepOCSortConfig(**cfg), device="cpu")
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
LT, LS, LN, HW, LD = 4, 8, 6, (32, 16), 32


def test_live_reid_rollout_at_the_deployed_cadence_matches_jax():
    """bench.py's DEPLOYED point for DeepOC-SORT (--emb-cadence 8, with
    bench_livereid's embedding_off=False, cmc_off=True and min_hits=1):
    OSNet x0_25 with the flax weights carried across, every OSBlock
    through osblock_fused."""
    jmodel = jax_osnet(feature_dim=LD)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = state_dict_from_flax(variables)
    model = infer_osnet(sd)
    model.load_state_dict(sd)
    rng = np.random.default_rng(5)
    dets, masks = synth_stream_dets(rng, LT, LS, LN, n_obj=4)
    crops = rng.integers(0, 255, (LT, LS, LN) + HW + (3,)).astype(np.uint8)
    cfg = dict(min_hits=1, embedding_off=False, cmc_off=True, emb_dim=LD,
               max_tracks=16, max_dets=LN)
    jinit, jstep = jax_make(JaxConfig(**cfg))
    jrunner = JaxRunner(jinit, jstep, LS, devices=jax.devices()[:1],
                        embed_fn=jax_embed_fn(jmodel, variables, fused=True),
                        emb_cadence=8)
    wo, wm = (np.asarray(a) for a in jrunner.run(
        jnp.asarray(dets), jnp.asarray(masks), embs=jnp.asarray(crops)))
    init, step = make_deepocsort(DeepOCSortConfig(**cfg), device="cpu")
    runner = MultiStreamRunner(init, step, LS, device="cpu",
                               embed_fn=make_embed_fn(model, fused=True,
                                                      device="cpu"),
                               emb_cadence=8)
    go, gm = runner.run(dets, masks, embs=crops)
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert int(wm.sum()) > 0
    np.testing.assert_array_equal(go[..., 4].numpy()[wm], wo[..., 4][wm])
    np.testing.assert_allclose(go.numpy()[wm], wo[wm], atol=1e-4, rtol=0)
