"""Port parity: the plain-torch ECC of motcpp_tpu_torch (``phase_shift``,
``ecc_jax_batch``, ``ECCJax``) and the runner's live camera-motion leg
against the JAX package on the same frames.

The ECC is held on textured shifts (sub-pixel, inside and far outside
Gauss-Newton's basin, up to a fifth of the frame) and on a flat pair
that must fail: the integer phase-correlation shift must be equal (the
FFTs of XLA and pocketfft round differently, the peak must not move),
the ok flags equal and the warps within 1e-4 px (the masked sums
accumulate in another order). The live-CMC rollouts (``ecc_jax_batch``
and ``sof_jax_batch`` as ``cmc_fn``, alone and under live ReID at a
cadence and at a priority budget, in one run() and split across two)
must emit the JAX runner's masks and ids, with boxes within 1e-3 px
(1e-4 px under live ReID, as tests/test_torch_live_reid.py) for the
ECC and within 1e-2 px for the sparse flow, whose warps agree to 1e-4
at CMC scale (tests/test_torch_cmc.py) and are rescaled by 1/0.15.
"""

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
from motcpp_tpu.data.synthetic import camera_pan_scene
from motcpp_tpu.models import strongsort as jss
from motcpp_tpu.motion import cmc as jcmc
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch.appearance.osnet import infer_osnet, state_dict_from_flax
from motcpp_tpu_torch.appearance.reid import make_embed_fn
from motcpp_tpu_torch.data import pan_frames, synth_stream_dets
from motcpp_tpu_torch.models import strongsort as ss
from motcpp_tpu_torch.motion import cmc
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

import torch_threads  # noqa: F401  (torch at one thread)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_cmc import _shift, _textured  # noqa: E402


WARP_ATOL = 1e-4
# (dx, dy): inside the basin, sub-pixel start, far outside it, a fifth
# of the frame, none
SHIFTS = [(7, 4), (-6, 3), (0, 0), (24, -11), (40, -25), (-60, 30), (2, 3)]


def jax_phase_shift(prev, cur):
    """The JAX package's phase-correlation init (motion/cmc.py:363-377,
    inside ``_ecc_jax_core``), through XLA's FFT, for one pair."""
    H, W = prev.shape
    wy = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * jnp.arange(H) / H)
    wx = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * jnp.arange(W) / W)
    win = wy[:, None] * wx[None, :]
    f1 = jnp.fft.rfft2((prev - prev.mean()) * win)
    f2 = jnp.fft.rfft2((cur - cur.mean()) * win)
    xps = f1 * jnp.conj(f2)
    xps = xps / (jnp.abs(xps) + 1e-9)
    peak = jnp.argmax(jnp.fft.irfft2(xps, s=(H, W)))
    py = (peak // W).astype(jnp.float32)
    px = (peak % W).astype(jnp.float32)
    py = jnp.where(py > H / 2, py - H, py)
    px = jnp.where(px > W / 2, px - W, px)
    return -px, -py


@pytest.fixture(scope="module")
def pairs():
    """The SHIFTS on seeded textures, a pair shifted by (1.3, -0.6) px
    bilinearly, and a flat pair (no signal: ok must be False)."""
    prevs, curs = [], []
    for s, (dx, dy) in enumerate(SHIFTS):
        img = _textured(seed=10 + s)[:, :, 0].astype(np.float32)
        prevs.append(img)
        curs.append(_shift(img[..., None], dx, dy)[..., 0].astype(np.float32))
    img = _textured(seed=30)[:, :, 0].astype(np.float32)
    ys, xs = np.meshgrid(np.arange(240) + 0.6, np.arange(320) - 1.3,
                         indexing="ij")
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = ys - y0, xs - x0

    def at(y, x):
        return img[np.clip(y, 0, 239), np.clip(x, 0, 319)]

    sub = (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
           + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)
    prevs.append(img)
    curs.append(sub.astype(np.float32))
    prevs.append(np.full_like(img, 127.0))
    curs.append(np.full_like(img, 127.0))
    return np.stack(prevs), np.stack(curs)


def test_phase_shift_matches_jax(pairs):
    tx, ty = cmc.phase_shift(*(torch.from_numpy(a) for a in pairs))
    for s in range(pairs[0].shape[0]):
        jtx, jty = jax_phase_shift(*(jnp.asarray(a[s]) for a in pairs))
        assert (float(tx[s]), float(ty[s])) == (float(jtx), float(jty)), s
    # the integer part of every textured shift
    want = np.asarray(SHIFTS + [(1, -1)], np.float32)
    np.testing.assert_array_equal(tx.numpy()[:-1], want[:, 0])
    np.testing.assert_array_equal(ty.numpy()[:-1], want[:, 1])


def test_ecc_jax_batch_matches_jax(pairs):
    got, ok = cmc.ecc_jax_batch(*(torch.from_numpy(a) for a in pairs))
    want, jok = jcmc.ecc_jax_batch(*(jnp.asarray(a) for a in pairs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WARP_ATOL)
    assert ok.numpy().tolist() == [True] * (len(SHIFTS) + 1) + [False]
    got = got.numpy()
    np.testing.assert_array_equal(got[-1], cmc.IDENTITY)
    np.testing.assert_allclose(got[:len(SHIFTS), :, 2], SHIFTS, atol=1e-3)
    np.testing.assert_allclose(got[len(SHIFTS), :, 2], [1.3, -0.6],
                               atol=0.05)
    # fewer iterations: the same function of n_iters
    got2, _ = cmc.ecc_jax_batch(*(torch.from_numpy(a) for a in pairs),
                                n_iters=2)
    want2, _ = jcmc.ecc_jax_batch(*(jnp.asarray(a) for a in pairs),
                                  n_iters=2)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=0,
                               atol=WARP_ATOL)


def test_ecc_jax_class_matches_jax():
    """ECCJax over camera_pan_scene (240x320 at 0.15: a 36x48 frame, the
    translation rescaled by the achieved per-axis scales): identity
    first, then each pair's warp; reset() restarts."""
    frames, _, _ = camera_pan_scene(n_frames=8)
    est, jest = cmc.ECCJax(device="cpu"), jcmc.ECCJax()
    for img in frames:
        got, want = est.apply(img), jest.apply(img)
        assert got.shape == (2, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, :2], np.eye(2), atol=1e-6)
    assert abs(got[0, 2] + 3.0) < 1.0
    est.reset()
    np.testing.assert_array_equal(est.apply(frames[1]), cmc.IDENTITY)


# the live-CMC scene: S streams, T frames, N det slots, h x w frames at
# CMC scale; live ReID on LN of them with 32x16 crops and LD features
S, T, N, FH, FW, SCALE = 4, 8, 8, 48, 80, 0.15
LN, HW, LD = 6, (32, 16), 32


@pytest.fixture(scope="module")
def live_scene():
    """Seeded dets, panning frames (every pan of 0-3 px present), crops,
    and OSNet x0_25 as flax variables and as the port's model."""
    rng = np.random.default_rng(11)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=6)
    # seed 3 draws the pans (2, 0, 1, 3): every pan of 0-3 px
    frames = pan_frames(T, S, FH, FW,
                        torch.Generator().manual_seed(3))[0].numpy()
    crops = rng.integers(0, 255, (T, S, LN) + HW + (3,)).astype(np.uint8)
    jmodel = jax_osnet(feature_dim=LD)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = state_dict_from_flax(variables)
    model = infer_osnet(sd)
    model.load_state_dict(sd)
    return dets, masks, frames, crops, jmodel, variables, model


def runners(live_scene, cmc_name, reid=None):
    """The JAX and port runners over StrongSORT (bench.py's config:
    n_init=1, gallery_cap=16) with the estimator as cmc_fn at CMC scale
    0.15; ``reid`` is None (no embeddings) or the live-ReID keywords."""
    jmodel, variables, model = live_scene[4:]
    cfg = dict(n_init=1, gallery_cap=16, max_tracks=16,
               max_dets=LN if reid else N, emb_dim=LD)
    jfn = getattr(jcmc, f"{cmc_name}_jax_batch")
    fn = getattr(cmc, f"{cmc_name}_jax_batch")
    jkw, kw = dict(reid or {}), dict(reid or {})
    if reid:
        jkw["embed_fn"] = jax_embed_fn(jmodel, variables, fused=True)
        kw["embed_fn"] = make_embed_fn(model, fused=True, device="cpu")
    jinit, jstep = jss.make_strongsort(jss.StrongSortConfig(**cfg))
    init, step = ss.make_strongsort(ss.StrongSortConfig(**cfg), device="cpu")
    return (JaxRunner(jinit, jstep, S, devices=jax.devices()[:1], cmc_fn=jfn,
                      cmc_scale=SCALE, **jkw),
            MultiStreamRunner(init, step, S, device="cpu", cmc_fn=fn,
                              cmc_scale=SCALE, **kw))


def run_both(jrunner, runner, dets, masks, frames, crops, splits):
    """Both runners over the frames in run() calls cut at ``splits``;
    returns the port's and JAX's (outs, masks), concatenated."""
    got, want = [], []
    cuts = [0, *splits, dets.shape[0]]
    for a, b in zip(cuts[:-1], cuts[1:]):
        extra = {} if crops is None else {"embs": crops[a:b]}
        want.append(jrunner.run(
            jnp.asarray(dets[a:b]), jnp.asarray(masks[a:b]),
            frames=jnp.asarray(frames[a:b]),
            **{k: jnp.asarray(v) for k, v in extra.items()}))
        got.append(runner.run(dets[a:b], masks[a:b], frames=frames[a:b],
                              **extra))
    g = [torch.cat([p[i] for p in got]).numpy() for i in range(2)]
    w = [np.concatenate([np.asarray(p[i]) for p in want]) for i in range(2)]
    return g, w


def assert_emissions_equal(got, want, atol):
    (go, gm), (wo, wm) = got, want
    np.testing.assert_array_equal(gm, wm)
    assert int(wm.sum()) > 0
    np.testing.assert_array_equal(go[..., 4][wm], wo[..., 4][wm])
    np.testing.assert_allclose(go[wm], wo[wm], rtol=0, atol=atol)


@pytest.mark.parametrize("cmc_name,splits", [
    ("ecc", ()), ("ecc", (3,)), ("sof", ()), ("sof", (3,))],
    ids=["ecc-one_run", "ecc-two_runs", "sof-one_run", "sof-two_runs"])
def test_live_cmc_rollout_matches_jax_runner(live_scene, cmc_name, splits):
    """One run() and two (the previous frame carries across the calls)."""
    dets, masks, frames = live_scene[:3]
    got, want = run_both(*runners(live_scene, cmc_name), dets, masks, frames,
                         None, splits)
    assert_emissions_equal(got, want, 1e-3 if cmc_name == "ecc" else 1e-2)


@pytest.mark.parametrize("reid", [
    dict(emb_cadence=2), dict(crop_budget=16, emb_priority=True)],
    ids=["cadence", "priority"])
def test_live_cmc_with_live_reid_matches_jax_runner(live_scene, reid):
    """Live ECC composed with live ReID at a cadence and at a priority
    budget (16 of up to 24 crops), split across two run() calls."""
    dets, masks, frames, crops = live_scene[:4]
    got, want = run_both(*runners(live_scene, "ecc", reid), dets[:, :, :LN],
                         masks[:, :, :LN], frames, crops, (3,))
    assert_emissions_equal(got, want, 1e-4)


def test_live_cmc_carry_pure_calls_and_reset(live_scene):
    """The live leg equals a with_warps rollout fed the estimator's
    warps frame by frame (identity first); the leg is live (a no-CMC
    rollout differs); a pure states= call reads the carried previous
    frame without updating it; reset() clears it."""
    dets, masks, frames = live_scene[:3]
    _, runner = runners(live_scene, "ecc")
    live = runner.run(dets, masks, frames=frames)
    warps = np.tile(cmc.IDENTITY, (T, S, 1, 1))
    for t in range(1, T):
        w, _ = cmc.ecc_jax_batch(torch.from_numpy(frames[t - 1]),
                                 torch.from_numpy(frames[t]))
        w = w.numpy()
        w[..., 2] *= np.float32(1.0 / SCALE)
        warps[t] = w
    init, step = ss.make_strongsort(ss.StrongSortConfig(
        n_init=1, gallery_cap=16, max_tracks=16, max_dets=N, emb_dim=LD),
        device="cpu")
    fed = MultiStreamRunner(init, step, S, device="cpu", with_warps=True).run(
        dets, masks, warps=warps)
    assert torch.equal(live[1], fed[1]) and torch.equal(live[0], fed[0])
    plain = MultiStreamRunner(init, step, S, device="cpu").run(dets, masks)
    assert not (torch.equal(plain[1], live[1])
                and torch.equal(plain[0], live[0]))

    # pure: the first frame's warps come from the carried last frame
    carried = runner._prev_frames.clone()
    states = runner.states
    pure = runner.run(dets[:2], masks[:2], frames=frames[:2], states=states)
    assert torch.equal(runner._prev_frames, carried)
    cont = MultiStreamRunner(init, step, S, device="cpu",
                             cmc_fn=cmc.ecc_jax_batch, cmc_scale=SCALE)
    cont.run(dets, masks, frames=frames)
    again = cont.run(dets[:2], masks[:2], frames=frames[:2])
    assert torch.equal(pure[1], again[1]) and torch.equal(pure[0], again[0])
    runner.reset()
    assert runner._prev_frames is None
    fresh = runner.run(dets, masks, frames=frames)
    assert torch.equal(fresh[1], live[1]) and torch.equal(fresh[0], live[0])
