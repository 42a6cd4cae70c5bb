"""Port parity: the live-ReID multi-stream rollout of motcpp_tpu_torch
against the JAX package's on the same seeded scene.

Raw uint8 crops go through OSNet (x0_25, 32x16 crops, every OSBlock
through ``osblock_fused``: the Pallas kernel in interpret mode on the
JAX side, its plain version on the CPU on the port's side) into
BoT-SORT, every frame and at an embedding cadence of 2. Masks and ids
must be identical; boxes agree to 1e-4 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.appearance.osnet import init_params as jax_init
from motcpp_tpu.appearance.osnet import osnet_x0_25 as jax_osnet
from motcpp_tpu.appearance.reid import make_embed_fn as jax_embed_fn
from motcpp_tpu.models.botsort import BotSortConfig as JaxConfig
from motcpp_tpu.models.botsort import make_botsort as jax_make
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch.appearance.osnet import state_dict_from_flax
from motcpp_tpu_torch.appearance.reid import make_embed_fn
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort
from motcpp_tpu_torch.parallel.streams import (
    MultiStreamRunner,
    make_rollout_embs,
    make_rollout_general,
)

import torch_threads  # noqa: F401  (torch at one thread)

T, S, N, HW, D = 3, 4, 4, (32, 16), 32
CFG = dict(with_reid=True, emb_dim=D, max_tracks=16, max_dets=N)


@pytest.fixture(scope="module")
def scene():
    """Flax variables, the port's OSNet with the same weights, and a
    seeded scene of dets, masks and crops."""
    from motcpp_tpu_torch.appearance.osnet import infer_osnet

    jmodel = jax_osnet(feature_dim=D)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = state_dict_from_flax(variables)
    model = infer_osnet(sd)
    model.load_state_dict(sd)
    rng = np.random.default_rng(5)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=3)
    crops = rng.integers(0, 255, (T, S, N) + HW + (3,)).astype(np.uint8)
    return jmodel, variables, model, dets, masks, crops


def jax_run(scene, **kw):
    jmodel, variables, _, dets, masks, crops = scene
    init, step = jax_make(JaxConfig(**CFG))
    runner = JaxRunner(init, step, S, devices=jax.devices()[:1],
                       embed_fn=jax_embed_fn(jmodel, variables, fused=True),
                       **kw)
    outs, out_masks = runner.run(jnp.asarray(dets), jnp.asarray(masks),
                                 embs=jnp.asarray(crops))
    return np.asarray(outs), np.asarray(out_masks)


def port_runner(scene, **kw):
    model = scene[2]
    init, step = make_botsort(BotSortConfig(**CFG), device="cpu")
    return MultiStreamRunner(init, step, S, device="cpu",
                             embed_fn=make_embed_fn(model, fused=True,
                                                    device="cpu"), **kw)


def assert_same_emissions(got, want):
    (go, gm), (wo, wm) = got, want
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert int(wm.sum()) > 0
    np.testing.assert_array_equal(go[..., 4].numpy()[wm], wo[..., 4][wm])
    np.testing.assert_allclose(go.numpy()[wm], wo[wm], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"emb_cadence": 2}],
                         ids=["every_frame", "cadence_2"])
def test_live_reid_rollout_matches_jax(scene, kw):
    _, _, _, dets, masks, crops = scene
    got = port_runner(scene, **kw).run(dets, masks, embs=crops)
    assert_same_emissions(got, jax_run(scene, **kw))


def test_cadence_phase_carries_across_runs_and_pure_calls(scene):
    """Two runs of T=1 and T=2 continue the phase of one run of T=3; a
    call with explicit states is pure and starts at ``frame0``."""
    _, _, _, dets, masks, crops = scene
    whole = port_runner(scene, emb_cadence=2).run(dets, masks, embs=crops)
    r = port_runner(scene, emb_cadence=2)
    first = r.run(dets[:1], masks[:1], embs=crops[:1])
    states = r.states
    rest = r.run(dets[1:], masks[1:], embs=crops[1:])
    for a, b in zip(whole, (torch.cat([first[0], rest[0]]),
                            torch.cat([first[1], rest[1]]))):
        assert torch.equal(a, b)
    pure = r.run(dets[1:], masks[1:], embs=crops[1:], states=states, frame0=1)
    assert torch.equal(pure[1], rest[1]) and torch.equal(pure[0], rest[0])
    assert r._frame0 == T


def test_rollout_with_precomputed_embs_equals_live(scene):
    """make_rollout_embs fed the features that embed_fn computes gives
    the live rollout's emissions."""
    model, dets, masks, crops = scene[2], *scene[3:]
    embed = make_embed_fn(model, fused=True, device="cpu")
    embs = embed(torch.from_numpy(crops.reshape((-1,) + HW + (3,))))
    init, step = make_botsort(BotSortConfig(**CFG), device="cpu")
    _, want = make_rollout_general(step, embed_fn=embed)(
        init(S), torch.from_numpy(dets), torch.from_numpy(masks),
        torch.from_numpy(crops))
    _, got = make_rollout_embs(step)(
        init(S), torch.from_numpy(dets), torch.from_numpy(masks),
        embs.reshape(T, S, N, D))
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_runner_rejects_what_is_not_ported(scene):
    init, step = make_botsort(BotSortConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="emb_priority needs crop_budget"):
        MultiStreamRunner(init, step, S, device="cpu",
                          embed_fn=lambda c: c, emb_priority=True)
    with pytest.raises(ValueError, match="emb_priority replaces emb_cadence"):
        MultiStreamRunner(init, step, S, device="cpu",
                          embed_fn=lambda c: c, crop_budget=4,
                          emb_priority=True, emb_cadence=2)
    with pytest.raises(ValueError, match="cmc_fn replaces the warps"):
        MultiStreamRunner(init, step, S, device="cpu", with_warps=True,
                          cmc_fn=lambda prev, cur: None)
    with pytest.raises(ValueError, match="emb_cadence requires embed_fn"):
        MultiStreamRunner(init, step, S, device="cpu", emb_cadence=2)
    runner = port_runner(scene)
    with pytest.raises(ValueError, match="frame0 only applies"):
        runner.run(*scene[3:5], embs=scene[5], frame0=1)
    with pytest.raises(ValueError, match="pass embs"):
        runner.run(*scene[3:5])
    with pytest.raises(ValueError, match="pass frames"):
        runner.run(*scene[3:5], embs=scene[5], frames=scene[5][..., 0, 0, 0])
