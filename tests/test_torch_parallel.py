"""Port parity: the sharded MultiStreamRunner and the emission collectives
of motcpp_tpu_torch against the JAX package's on its 8 CPU devices.

The same seeded inputs go through the JAX runner sharded over
``jax.devices()[:n]`` (``shard_map``) and through the port's runner
over ``devices=["cpu"] * n`` (n shards on the one CPU device, each run
by a one-device runner). Masks and ids must be identical, confidences
agree at rtol 1e-5 and boxes within 1e-3 px (1e-4 px under live ReID,
1e-3 px under live ECC), the tolerances of the port's one-device tests.
Inside the port a sharded run must equal the one-device run bit for bit
wherever the JAX package's does (everywhere but at a crop budget that
binds: the budget is per shard), and a carry crosses between the two
layouts. Live ReID runs osnet_x0_25 (feature_dim 32, 32x16 crops) with
the same weights on both sides: the JAX side's BN-folded forward, the
port's ``fused=True`` embed (the OSBlock kernel's plain version here).
"""

import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu import parallel as jpar
from motcpp_tpu.appearance.osnet import init_params as jax_init
from motcpp_tpu.appearance.osnet import osnet_x0_25 as jax_osnet
from motcpp_tpu.appearance.reid import make_embed_fn as jax_embed_fn
from motcpp_tpu_torch.appearance.osnet import infer_osnet, state_dict_from_flax
from motcpp_tpu_torch.appearance.reid import make_embed_fn
from motcpp_tpu_torch.device import PerDevice
from motcpp_tpu_torch.parallel import (
    Mesh,
    MultiStreamRunner,
    emission_stats,
    per_stream_emissions,
    shard_over_streams,
)

BOX_ATOL, LIVE_BOX_ATOL = 1e-3, 1e-4
HW, D = (32, 16), 32


def jax_pair(name, **cfg):
    import importlib

    mod = importlib.import_module(f"motcpp_tpu.models.{name}")
    conf = next(getattr(mod, a) for a in dir(mod) if a.endswith("Config"))
    return getattr(mod, f"make_{name}")(conf(**cfg))


def port_pair(name, **cfg):
    import importlib

    mod = importlib.import_module(f"motcpp_tpu_torch.models.{name}")
    conf = next(getattr(mod, a) for a in dir(mod) if a.endswith("Config"))
    return getattr(mod, f"make_{name}")(conf(**cfg), device="cpu")


def jax_runner(pair, S, n, **kw):
    return jpar.MultiStreamRunner(*pair, n_streams=S,
                                  devices=jax.devices()[:n], **kw)


def port_runner(pair, S, n=None, **kw):
    """One device (n None) or n shards on the CPU."""
    if n is None:
        return MultiStreamRunner(*pair, S, device="cpu", **kw)
    return MultiStreamRunner(*pair, S, devices=["cpu"] * n, **kw)


def jax_run(runner, *args, **kw):
    out = runner.run(*(jnp.asarray(a) for a in args),
                     **{k: jnp.asarray(v) for k, v in kw.items()})
    return tuple(np.asarray(x) for x in out)


def assert_same(got, want, box_atol=BOX_ATOL):
    """The port's (outs, masks) against the JAX package's: masks and ids
    identical, confidences at rtol 1e-5, boxes within ``box_atol``."""
    (go, gm), (wo, wm) = [tuple(np.asarray(x) for x in p) for p in (got, want)]
    np.testing.assert_array_equal(gm, wm)
    assert int(wm.sum()) > 0  # the scenario emits tracks
    g, w = go[wm], wo[wm]
    np.testing.assert_array_equal(g[:, [4, 6, 7]], w[:, [4, 6, 7]])
    np.testing.assert_allclose(g[:, 5], w[:, 5], rtol=1e-5, atol=0)
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=box_atol)


def assert_equal(a, b):
    """Two port runs, bit for bit."""
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def mini_inputs(T=4, S=4, N=4):
    """tests/test_parallel.py's scene: one box a stream, drifting."""
    dets = np.zeros((T, S, N, 6), np.float32)
    masks = np.zeros((T, S, N), bool)
    for s in range(S):
        for t in range(T):
            dets[t, s, 0] = [10 * s + t, 20, 10 * s + t + 60, 140, 0.9, 0]
            masks[t, s, 0] = True
    return dets, masks


def live_scene(T=4, S=4, N=6, seed=3, valid_p=0.8):
    """tests/test_parallel.py::_live_reid_scene's dets, masks and crops."""
    rng = np.random.default_rng(seed)
    dets = np.zeros((T, S, N, 6), np.float32)
    cx = rng.uniform(100, 500, (T, S, N))
    cy = rng.uniform(100, 400, (T, S, N))
    dets[..., 0] = cx - 30
    dets[..., 1] = cy - 60
    dets[..., 2] = cx + 30
    dets[..., 3] = cy + 60
    dets[..., 4] = rng.uniform(0.6, 1.0, (T, S, N))
    masks = rng.random((T, S, N)) < valid_p
    crops = rng.integers(0, 255, (T, S, N) + HW + (3,)).astype(np.uint8)
    return dets, masks, crops


@pytest.fixture(scope="module")
def embeds():
    """osnet_x0_25 (feature_dim 32) at 32x16: the JAX package's BN-folded
    embed and the port's fused embed of the same weights."""
    jmodel = jax_osnet(feature_dim=D)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = state_dict_from_flax(variables)
    model = infer_osnet(sd)
    model.load_state_dict(sd)
    return (jax_embed_fn(jmodel, variables, folded=True),
            make_embed_fn(model, fused=True, device="cpu"))


def jax_stub_embed(dim):
    """tests/test_parallel.py::_stub_embed: feature 0 = mean pixel + 1."""
    def embed_fn(crops):
        v = jnp.mean(crops.astype(jnp.float32), axis=(1, 2, 3))
        return jnp.zeros((crops.shape[0], dim), jnp.float32).at[:, 0].set(
            v + 1.0)
    return embed_fn


def port_stub_embed(dim):
    def embed_fn(crops):
        out = torch.zeros((crops.shape[0], dim))
        out[:, 0] = crops.float().mean((1, 2, 3)) + 1.0
        return out
    return embed_fn


# ---------------------------------------------------------------------------
# the sharded runner
# ---------------------------------------------------------------------------


def test_sharded_sort_matches_jax_and_one_device():
    """SORT over 8 shards equals the port's one-device run bit for bit
    and the JAX runner over 8 devices (tests/test_parallel.py:35)."""
    cfg = dict(min_hits=1, max_tracks=8, max_dets=4)
    dets, masks = mini_inputs(T=4, S=8)
    got = port_runner(port_pair("sort", **cfg), 8, 8).run(dets, masks)
    assert got[0].shape == (4, 8, 8, 8) and got[0].device.type == "cpu"
    assert_equal(got, port_runner(port_pair("sort", **cfg), 8).run(dets,
                                                                   masks))
    assert_same(got, jax_run(jax_runner(jax_pair("sort", **cfg), 8, 8),
                             dets, masks))


def test_sharded_strongsort_with_embeddings_matches_jax():
    """StrongSORT with per-detection embeddings over 8 shards
    (tests/test_parallel.py:88); a missing embs raises."""
    S, T, N, Dm = 16, 6, 4, 8
    cfg = dict(n_init=1, max_tracks=8, max_dets=N, emb_dim=Dm)
    rng = np.random.default_rng(0)
    dets = np.zeros((T, S, N, 6), np.float32)
    masks = np.zeros((T, S, N), bool)
    embs = rng.normal(0, 1, (T, S, N, Dm)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    for t in range(T):
        for i in range(2):
            dets[t, :, i] = [100 + 120 * i + 3 * t, 100, 180 + 120 * i + 3 * t,
                             300, 0.9, 0]
            masks[t, :, i] = True
    embs = np.broadcast_to(embs[0], (T, S, N, Dm)).copy()
    runner = port_runner(port_pair("strongsort", **cfg), S, 8,
                         with_embs=True)
    got = runner.run(dets, masks, embs)
    assert got[0].shape == (T, S, 8, 8)
    assert_equal(got, port_runner(port_pair("strongsort", **cfg), S,
                                  with_embs=True).run(dets, masks, embs))
    assert_same(got, jax_run(jax_runner(jax_pair("strongsort", **cfg), S, 8,
                                        with_embs=True), dets, masks, embs))
    with pytest.raises(ValueError):
        runner.run(dets, masks)  # missing embs


def bytetrack_scene(S=16, T=12, N=4):
    """tests/test_parallel.py:124's scene."""
    rng = np.random.default_rng(0)
    dets = rng.uniform(100, 900, (T, S, N, 6)).astype(np.float32)
    dets[..., 2:4] = dets[..., 0:2] + 80.0
    dets[..., 4] = 0.9
    dets[..., 5] = 0.0
    return dets, np.ones((T, S, N), bool)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
@pytest.mark.parametrize("direction", ["sharded_to_one", "one_to_sharded"])
def test_checkpoint_crosses_layouts(tmp_path, direction, fmt):
    """A carry saved mid-stream from a sharded runner continues in a
    one-device runner, and the other way round, bit for bit against an
    uninterrupted run, which equals the JAX runner over 8 devices
    (tests/test_parallel.py:124, whose runners take every device)."""
    from motcpp_tpu_torch.utils.checkpoint import load_state, save_state

    S, T = 16, 12
    cfg = dict(max_tracks=8, max_dets=4)
    pair = port_pair("bytetrack", **cfg)
    dets, masks = bytetrack_scene(S, T)
    full = port_runner(pair, S, 4).run(dets, masks)
    assert_same(full, jax_run(jax_runner(jax_pair("bytetrack", **cfg), S, 8),
                              dets, masks))
    first, then = (4, None) if direction == "sharded_to_one" else (None, 4)
    a = port_runner(pair, S, first)
    a.run(dets[:T // 2], masks[:T // 2])
    path = tmp_path / f"carry.{fmt}"
    save_state(a.states, path)
    b = port_runner(pair, S, then)
    restored = load_state(b.init_states(), path)
    pure = b.run(dets[T // 2:], masks[T // 2:], states=restored)
    b.set_states(restored)
    carried = b.run(dets[T // 2:], masks[T // 2:])
    for got in (pure, carried):
        assert_equal(got, (full[0][T // 2:], full[1][T // 2:]))
    a.run(dets[T // 2:], masks[T // 2:])
    assert_equal(b.states, a.states)


def test_sharded_states_are_copies_in_the_one_device_layout():
    """``states`` of a sharded runner is one state over all S streams (a
    copy), ``init_states`` is the one-device runner's, and a pure
    ``states=`` call leaves the carry as it was."""
    cfg = dict(min_hits=1, max_tracks=8, max_dets=4)
    pair = port_pair("sort", **cfg)
    dets, masks = mini_inputs(T=4, S=8)
    r = port_runner(pair, 8, 4)
    assert r.states is None
    fresh = r.init_states()
    assert_equal(fresh, port_runner(pair, 8).init_states())
    r.run(dets[:2], masks[:2])
    snap = r.states
    assert snap.x.shape[0] == 8
    kept = type(snap)(*(t.clone() for t in snap))
    r.run(dets[2:], masks[2:], states=fresh)  # pure
    assert_equal(r.states, kept)
    r.run(dets[2:], masks[2:])
    assert_equal(snap, kept)  # a copy: the run left it as it was
    r.reset()
    assert r.states is None


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 8])
def test_collectives_match_jax(n_dev):
    """emission_stats and per_stream_emissions over the sharded masks,
    whole or as shard_over_streams' chunks, equal the JAX package's
    psum / pmax / all_gather and the plain reductions
    (tests/test_parallel.py:197)."""
    from jax.sharding import Mesh as JaxMesh

    T, S = 5, 8
    cfg = dict(min_hits=1, max_tracks=8, max_dets=4)
    dets, masks = mini_inputs(T=T, S=S)
    masks[:, 3] = False  # one silent stream
    _, out_masks = port_runner(port_pair("sort", **cfg), S, n_dev).run(
        dets, masks)
    mesh = Mesh(["cpu"] * n_dev)
    jmesh = JaxMesh(np.asarray(jax.devices()[:n_dev]), ("streams",))
    jm = jpar.shard_over_streams(jmesh, jnp.asarray(out_masks.numpy()))
    want = jpar.emission_stats(jm, jmesh)
    chunks = shard_over_streams(mesh, out_masks)
    assert len(chunks) == n_dev and all(
        c.shape == (T, S // n_dev, 8) and c.device == d
        for c, d in zip(chunks, mesh))
    om = out_masks.numpy()
    for given in (out_masks, chunks, out_masks.numpy()):
        assert emission_stats(given, mesh) == want
        per = per_stream_emissions(given, mesh)
        assert per.dtype == torch.int32 and per.device == mesh[0]
        np.testing.assert_array_equal(
            per.numpy(), np.asarray(jpar.per_stream_emissions(jm, jmesh)))
    assert want["active_streams"] == S - 1
    assert want["peak_tracks_per_frame"] == int(om.sum(axis=2).max())
    assert per_stream_emissions(out_masks, mesh)[3] == 0
    flat = shard_over_streams(mesh, out_masks[0], t_leading=False)
    assert [tuple(c.shape) for c in flat] == [(S // n_dev, 8)] * n_dev


def test_mesh_names_one_device_one_way():
    """A mesh holds canonical devices; ``PerDevice`` keeps one copy per
    device however it is named."""
    mesh = Mesh(["cpu", torch.device("cpu")])
    assert mesh == (torch.device("cpu"),) * 2
    built = []
    pd = PerDevice(lambda d: built.append(d) or (torch.ones(2, device=d),),
                   "cpu")
    assert pd.on(torch.device("cpu")) is pd.on("cpu")
    assert built == [torch.device("cpu")]
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])


# ---------------------------------------------------------------------------
# live legs, sharded
# ---------------------------------------------------------------------------


def pan_scene(S=2, T=6, N=8, h=64, w=96):
    """tests/test_parallel.py:326's textured scenes panning at 3 and 5 px
    a frame, with one static object dragged by the pan."""
    def textured(seed):
        im = np.zeros((h, w * 3), np.float32)
        r = np.random.default_rng(seed)
        for scale in (4, 8, 16):
            small = r.random((h // scale + 2, w * 3 // scale + 2))
            im += np.kron(small, np.ones((scale, scale)))[:h, :w * 3]
        return (im / im.max() * 255).astype(np.float32)

    scenes = [textured(40 + s) for s in range(S)]
    pans = [3, 5]
    frames = np.zeros((T, S, h, w), np.float32)
    dets = np.zeros((T, S, N, 6), np.float32)
    masks = np.zeros((T, S, N), bool)
    for t in range(T):
        for s in range(S):
            frames[t, s] = scenes[s][:, pans[s] * t:pans[s] * t + w]
            x = 20 + pans[s] * t
            dets[t, s, 0] = [x, 10, x + 14, 40, 0.9, 0]
            masks[t, s, 0] = True
    return dets, masks, frames


def test_sharded_live_cmc_matches_jax():
    """BoT-SORT with live ECC (cmc_fn=ecc_jax_batch) over 2 shards equals
    the JAX runner over 2 devices and the port's one-device runner, the
    previous-frame carry held per shard across two run() calls
    (tests/test_parallel.py:326's sharded leg)."""
    from motcpp_tpu.motion.cmc import ecc_jax_batch as jax_ecc
    from motcpp_tpu_torch.motion.cmc import ecc_jax_batch

    S, scale = 2, 0.5
    cfg = dict(max_tracks=16, max_dets=8, with_reid=False)
    dets, masks, frames = pan_scene(S)
    pair = port_pair("botsort", **cfg)
    r = port_runner(pair, S, 2, cmc_fn=ecc_jax_batch, cmc_scale=scale)
    parts = [r.run(dets[a:b], masks[a:b], frames=frames[a:b])
             for a, b in ((0, 3), (3, 6))]
    got = tuple(torch.cat([p[i] for p in parts]) for i in range(2))
    assert_equal(got, port_runner(pair, S, cmc_fn=ecc_jax_batch,
                                  cmc_scale=scale).run(dets, masks,
                                                       frames=frames))
    assert_same(got, jax_run(jax_runner(jax_pair("botsort", **cfg), S, 2,
                                        cmc_fn=jax_ecc, cmc_scale=scale),
                             dets, masks, frames=frames), 1e-3)


def test_sharded_live_reid_matches_jax(embeds):
    """BoT-SORT with the CNN on raw crops over 4 shards, every frame and
    at a per-shard crop budget that covers each shard's valid crops,
    equals the one-device uncapped run bit for bit and the JAX runner
    over 4 devices (tests/test_parallel.py:422 and :524's sharded legs);
    the budget must divide over the devices."""
    jembed, embed = embeds
    T, S, N = 4, 4, 6
    dets, masks, crops = live_scene(T, S, N)
    cfg = dict(max_tracks=16, max_dets=N, emb_dim=D, with_reid=True)
    pair = port_pair("botsort", **cfg)
    one = port_runner(pair, S, embed_fn=embed).run(dets, masks, embs=crops)
    jpair = jax_pair("botsort", **cfg)
    per_shard = int(masks.reshape(T, 4, S // 4, N).sum(axis=(2, 3)).max())
    for budget in (None, per_shard * 4):
        got = port_runner(pair, S, 4, embed_fn=embed,
                          crop_budget=budget).run(dets, masks, embs=crops)
        assert_equal(got, one)
        assert_same(got, jax_run(jax_runner(jpair, S, 4, embed_fn=jembed,
                                            crop_budget=budget),
                                 dets, masks, embs=crops), LIVE_BOX_ATOL)


def test_sharded_cadence_uses_global_stream_ids(embeds):
    """DeepOC-SORT at embedding cadence 3 over 4 shards equals the
    one-device run bit for bit (the gate reads each shard's global
    stream ids) and the JAX runner over 4 devices; T=1 runs carry the
    phase (tests/test_parallel.py:581's sharded leg)."""
    jembed, embed = embeds
    T, S, N = 4, 8, 6
    dets, masks, crops = live_scene(T, S, N)
    cfg = dict(min_hits=1, max_tracks=16, max_dets=N, emb_dim=D,
               cmc_off=True)
    pair = port_pair("deepocsort", **cfg)
    got = port_runner(pair, S, 4, embed_fn=embed, emb_cadence=3).run(
        dets, masks, embs=crops)
    assert_equal(got, port_runner(pair, S, embed_fn=embed,
                                  emb_cadence=3).run(dets, masks, embs=crops))
    assert_same(got, jax_run(jax_runner(jax_pair("deepocsort", **cfg), S, 4,
                                        embed_fn=jembed, emb_cadence=3),
                             dets, masks, embs=crops), LIVE_BOX_ATOL)
    ticks = port_runner(pair, S, 4, embed_fn=embed, emb_cadence=3)
    parts = [ticks.run(dets[t:t + 1], masks[t:t + 1], embs=crops[t:t + 1])
             for t in range(T)]
    assert_equal(tuple(torch.cat([p[i] for p in parts]) for i in range(2)),
                 got)


def test_sharded_priority_budget_matches_jax():
    """StrongSORT at a priority budget that covers every crop, over 8
    shards: the plain live run bit for bit, the JAX runner over 8
    devices, and the previous dets carried per shard across two run()
    calls (tests/test_parallel.py:798)."""
    Dm, S, N, T = 8, 8, 4, 3
    cfg = dict(n_init=1, max_tracks=8, max_dets=N, emb_dim=Dm,
               gallery_cap=4)
    rng = np.random.default_rng(0)
    dets = np.zeros((T, S, N, 6), np.float32)
    dets[:, :, 0, :4] = [10, 10, 50, 90]
    dets[:, :, 1, :4] = [200, 10, 240, 90]
    dets[..., 4] = 0.9
    masks = np.zeros((T, S, N), bool)
    masks[:, :, :2] = True
    crops = rng.integers(0, 255, (T, S, N, 4, 4, 3)).astype(np.uint8)
    pair = port_pair("strongsort", **cfg)
    plain = port_runner(pair, S, embed_fn=port_stub_embed(Dm))
    pri = port_runner(pair, S, 8, embed_fn=port_stub_embed(Dm),
                      crop_budget=S * N, emb_priority=True)
    jpri = jax_runner(jax_pair("strongsort", **cfg), S, 8,
                      embed_fn=jax_stub_embed(Dm), crop_budget=S * N,
                      emb_priority=True)
    for _ in range(2):  # the second run carries the previous dets
        got = pri.run(dets, masks, embs=crops)
        assert_equal(got, plain.run(dets, masks, embs=crops))
        assert_same(got, jax_run(jpri, dets, masks, embs=crops))
    assert all(sh._prev_dets is not None for sh in pri._shards)


class Echo(NamedTuple):
    x: torch.Tensor


def echo_step(state, d, m, e):
    """A step that emits each detection's embedding as its output."""
    return state, (e, m)


@pytest.mark.parametrize("mode", ["confidence", "priority"])
def test_binding_budget_is_per_shard_as_in_jax(embeds, mode):
    """At a crop budget that binds, each shard embeds its own
    crop_budget / n crops: the port over 2 shards embeds exactly the
    crops the JAX runner over 2 devices embeds (an echo step shows which)
    and not those of the port's one-device run; through BoT-SORT the
    port over 2 shards emits what JAX over 2 devices emits."""
    jembed, embed = embeds
    T, S, N, budget = 3, 4, 6, 8
    dets, masks, crops = live_scene(T, S, N, seed=7)
    assert int(masks.sum(axis=(1, 2)).min()) > budget  # the budget binds
    kw = dict(crop_budget=budget, emb_priority=mode == "priority")

    def port_echo(n):
        runner = MultiStreamRunner(lambda S_: Echo(torch.zeros(S_)),
                                   echo_step, S, embed_fn=embed,
                                   **({"device": "cpu"} if n is None
                                      else {"devices": ["cpu"] * n}), **kw)
        return runner.run(dets, masks, embs=crops)[0].numpy()

    jecho = jpar.MultiStreamRunner(
        lambda: jnp.zeros(()), lambda st, d, m, e: (st, (e, m)), S,
        devices=jax.devices()[:2], embed_fn=jembed, **kw)
    want = np.asarray(jecho.run(jnp.asarray(dets), jnp.asarray(masks),
                                embs=jnp.asarray(crops))[0])
    sharded, one = port_echo(2), port_echo(None)
    embedded = np.abs(sharded).sum(-1) > 0
    np.testing.assert_array_equal(embedded, np.abs(want).sum(-1) > 0)
    assert (embedded.reshape(T, 2, -1).sum(-1) == budget // 2).all()
    np.testing.assert_allclose(sharded, want, atol=1e-5, rtol=0)
    assert (embedded != (np.abs(one).sum(-1) > 0)).any()

    cfg = dict(max_tracks=16, max_dets=N, emb_dim=D, with_reid=True)
    got = port_runner(port_pair("botsort", **cfg), S, 2, embed_fn=embed,
                      **kw).run(dets, masks, embs=crops)
    assert_same(got, jax_run(jax_runner(jax_pair("botsort", **cfg), S, 2,
                                        embed_fn=jembed, **kw),
                             dets, masks, embs=crops), LIVE_BOX_ATOL)


# ---------------------------------------------------------------------------
# argument checks, device independence, the two-process dryrun
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    "streams_do_not_divide", "budget_does_not_divide", "budget_without_embed",
    "device_contradicts_devices"])
def test_sharded_runner_validation_errors(embeds, case):
    """The JAX runner's checks, in its words, and a ``device`` that names
    another device than ``devices[0]``."""
    pair = port_pair("bytetrack", max_tracks=8, max_dets=4)
    kw, match = {
        "streams_do_not_divide": (dict(n_streams=5), "n_streams=5 must "
                                  "divide evenly over 2 devices"),
        "budget_does_not_divide": (dict(embed_fn=embeds[1], crop_budget=7),
                                   "crop_budget=7 must divide evenly over "
                                   "2 devices"),
        "budget_without_embed": (dict(with_embs=True, crop_budget=4),
                                 "crop_budget"),
        "device_contradicts_devices": (dict(device="meta"), "contradicts"),
    }[case]
    args = {"n_streams": 4, "devices": ["cpu", "cpu"], **kw}
    with pytest.raises(ValueError, match=match):
        MultiStreamRunner(*pair, **args)
    if case == "streams_do_not_divide":  # the JAX runner raises too
        with pytest.raises(ValueError, match="divide evenly"):
            jax_runner(jax_pair("bytetrack", max_tracks=8, max_dets=4), 5, 2)


def closure_values(fn):
    """(function, name, value) of every variable that ``fn`` and the
    functions it closes over, at any depth, close over."""
    seen, todo, out = set(), [fn], []
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        for var, cell in zip(f.__code__.co_freevars, f.__closure__ or ()):
            out.append((f, var, cell.cell_contents))
            if isinstance(cell.cell_contents, types.FunctionType):
                todo.append(cell.cell_contents)
    return out


@pytest.mark.parametrize("name", [
    "sort", "bytetrack", "ocsort", "deepocsort", "strongsort", "botsort",
    "boosttrack", "hybridsort", "ucmctrack"])
def test_no_tracker_step_holds_a_tensor(name):
    """A tracker's step follows its inputs' device: neither it nor a
    function it closes over holds a tensor (constants come from a
    PerDevice), so one step serves shards on several devices."""
    import importlib

    mod = importlib.import_module(f"motcpp_tpu_torch.models.{name}")
    conf = next(getattr(mod, a) for a in dir(mod) if a.endswith("Config"))
    cfgs = [conf()]
    if name == "ucmctrack":  # a calibration adds the inverse mapping
        Ko = np.eye(4)
        Ko[2, 3] = 1.0
        cfgs.append(conf(Ki=np.eye(3, 4).ravel().tolist(),
                         Ko=Ko.ravel().tolist()))
        assert cfgs[-1].inv_A() is not None
    for cfg in cfgs:
        step = getattr(mod, f"make_{name}")(cfg, device="cpu")[1]
        held = [(fn, var) for fn, var, value in closure_values(step)
                if isinstance(value, torch.Tensor)]
        assert not held


def test_embed_fn_follows_its_crops():
    """make_embed_fn runs where its crops are (host arrays on its own
    device) and holds one copy of the weights per device."""
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25

    model = init_params(osnet_x0_25(feature_dim=D), 0)
    crops = np.random.default_rng(0).integers(0, 255, (3,) + HW + (3,),
                                              dtype=np.uint8)
    for kw in ({"fused": True}, {"folded": True}, {}):
        embed = make_embed_fn(model, device="cpu", **kw)
        (weights,) = {id(v): v for _, _, v in closure_values(embed)
                      if isinstance(v, PerDevice)}.values()
        a = embed(crops)
        b = embed(torch.from_numpy(crops))
        assert torch.equal(a, b) and a.device.type == "cpu"
        assert list(weights._by_device) == [torch.device("cpu")]


def test_two_process_dryrun_on_the_cpu(monkeypatch):
    """dryrun_multihost: two processes over gloo, each with 4 shards of 2
    streams on the CPU, gather per-stream counts equal to one process's
    run of the whole scene."""
    from motcpp_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "TIMEOUT", 120.0)
    report = multihost.dryrun_multihost(2, device="cpu")
    assert report["ok"] and report["streams"] == 16
    assert report["emissions"] == sum(report["counts"]) > 0
