"""Port parity: the serving runtime of motcpp_tpu_torch (the
TrackingService over the stream mux, on the CPU) against the JAX
package's on one device, on the same submissions.

Ids, classes, detection indices and emission masks must be identical;
confidences agree at rtol 1e-5 and emitted boxes within 1e-3 px (1e-4 px
under live ReID), the tolerances of the port's tracker tests. Inside the
port, an absent or gappy stream continues bit for bit, recovered and
migrated streams continue bit for bit, and pipelined dispatch equals
sequential steps. Live ReID runs osnet_x0_25 (feature_dim 16, 32x16
crops) with the same weights on both sides (``state_dict_from_flax``):
the JAX side's BN-folded forward, the port's ``fused=True`` embed (the
OSBlock kernel's plain version on the CPU).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu.appearance.osnet import init_params as jax_init
from motcpp_tpu.appearance.osnet import osnet_x0_25 as jax_osnet
from motcpp_tpu.appearance.reid import make_embed_fn as jax_embed_fn
from motcpp_tpu.serving import TrackingService as JaxService
from motcpp_tpu_torch.appearance.osnet import infer_osnet, state_dict_from_flax
from motcpp_tpu_torch.appearance.reid import make_embed_fn
from motcpp_tpu_torch.serving import StreamMux, TrackingService
from test_torch_serving_mux import frame

HW, DIM = (32, 16), 16
BOX_ATOL, LIVE_BOX_ATOL = 1e-3, 1e-4
# motion-only configurations of the nine trackers
TRACKER_KW = {
    "sort": dict(min_hits=1),
    "bytetrack": {},
    "ocsort": dict(min_hits=1),
    "deepocsort": dict(min_hits=1, embedding_off=True, cmc_off=True),
    "strongsort": dict(n_init=1),
    "botsort": dict(with_reid=False),
    "boosttrack": dict(min_hits=1),
    "hybridsort": dict(min_hits=1, with_reid=False),
    "ucmctrack": dict(min_hits=1),
}
LIVE_CFG = dict(max_tracks=16, max_dets=8, emb_dim=DIM, with_reid=True)


def stream_frames(seed, T, n=4):
    """n boxes moving at (3, 1.5) px a frame."""
    base = frame(np.random.default_rng(seed), n)
    frames = []
    for t in range(T):
        f = base.copy()
        f[:, [0, 2]] += 3.0 * t
        f[:, [1, 3]] += 1.5 * t
        frames.append(f)
    return frames


def port_service(tracker="bytetrack", n_streams=2, max_dets=8, emb_dim=0,
                 tracker_kw=None, **kw):
    return TrackingService.from_tracker(
        tracker, n_streams=n_streams, max_dets=max_dets, emb_dim=emb_dim,
        tracker_kw={"max_tracks": 16, **(tracker_kw or {})}, device="cpu",
        **kw)


def jax_service(tracker="bytetrack", n_streams=2, max_dets=8, emb_dim=0,
                tracker_kw=None, **kw):
    return JaxService.from_tracker(
        tracker, n_streams=n_streams, max_dets=max_dets, emb_dim=emb_dim,
        tracker_kw={"max_tracks": 16, **(tracker_kw or {})},
        devices=jax.devices()[:1], **kw)


def drive(svc, n_handles, ticks):
    """Attach ``n_handles`` streams, then per tick submit ``{stream:
    (dets, submit keywords)}`` and step; returns, per tick, (present of
    each stream, each stream's emitted rows)."""
    hs = [svc.attach() for _ in range(n_handles)]
    out = []
    for sub in ticks:
        for i, (d, kw) in sub.items():
            svc.submit(hs[i], d, **kw)
        b = svc.step()
        out.append(([bool(b.present[h.slot]) for h in hs],
                    [b.tracks_for(h) for h in hs]))
    return out


def assert_same_rows(got, want, box_atol=BOX_ATOL):
    """Rows emitted by the port and by the JAX package: the same rows with
    the same ids, classes and detection indices, confidences at rtol
    1e-5, boxes within ``box_atol``."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, [4, 6, 7]], want[:, [4, 6, 7]])
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=box_atol)


def assert_same_drive(got, want, box_atol=BOX_ATOL):
    assert len(got) == len(want)
    emitted = 0
    for (gp, grows), (wp, wrows) in zip(got, want):
        assert gp == wp
        for g, w in zip(grows, wrows):
            assert_same_rows(g, w, box_atol)
            emitted += g.shape[0]
    assert emitted > 0  # the scenario actually emits tracks


def assert_state_equal(a, b):
    """Two states of one tracker, field by field, bit for bit."""
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


# ---------------------------------------------------------------------------
# irregular arrival, every tracker
# ---------------------------------------------------------------------------

GAPPY = [1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1, 1]


@pytest.mark.parametrize("name", sorted(TRACKER_KW))
def test_service_absent_streams_frozen_bit_exact(name):
    """Stream 0 gets 8 frames on consecutive ticks, stream 1 the same
    frames with idle gaps: the gappy stream emits byte-identical rows
    for each frame, and on every tick it is absent its state stays the
    same to the bit (no step writes into the state it is given). The
    JAX service emits the same rows for the same submissions."""
    frames = stream_frames(1, 8)
    ticks, i0, i1 = [], iter(frames), iter(frames)
    for t, has in enumerate(GAPPY):
        sub = {}
        if t < 8:
            sub[0] = (next(i0), {})
        if has:
            sub[1] = (next(i1), {})
        ticks.append(sub)

    svc = port_service(name, tracker_kw=TRACKER_KW[name])
    hs = [svc.attach() for _ in range(2)]
    got = []
    for sub in ticks:
        for i, (d, kw) in sub.items():
            svc.submit(hs[i], d, **kw)
        absent = [h for i, h in enumerate(hs) if i not in sub]
        frozen = [svc.export_stream(h) for h in absent]
        b = svc.step()
        for h, before in zip(absent, frozen):
            assert not b.present[h.slot]
            assert_state_equal(svc.export_stream(h), before)
        got.append(([bool(b.present[h.slot]) for h in hs],
                    [b.tracks_for(h) for h in hs]))

    dense = [rows[0] for p, rows in got if p[0]]
    gappy = [rows[1] for p, rows in got if p[1]]
    assert len(dense) == len(gappy) == 8
    for a, b in zip(dense, gappy):
        np.testing.assert_array_equal(a, b)
    assert_same_drive(got, drive(jax_service(name,
                                             tracker_kw=TRACKER_KW[name]),
                                 2, ticks))


def test_service_matches_raw_rollout():
    """A fully present service run emits what the port's
    MultiStreamRunner emits over the same frames, bit for bit."""
    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    S, N, T = 3, 8, 6
    streams = [stream_frames(10 + s, T, n=3) for s in range(S)]
    svc = port_service(n_streams=S, max_dets=N)
    handles = [svc.attach() for _ in range(S)]
    svc_outs = []
    for t in range(T):
        for s, h in enumerate(handles):
            svc.submit(h, streams[s][t])
        svc_outs.append(svc.step())

    init_fn, step_fn = make_bytetrack(ByteTrackConfig(max_tracks=16,
                                                      max_dets=N),
                                      device="cpu")
    dets = np.zeros((T, S, N, 6), np.float32)
    masks = np.zeros((T, S, N), bool)
    for s in range(S):
        for t in range(T):
            dets[t, s, :3] = streams[s][t]
            masks[t, s, :3] = True
    outs, out_masks = MultiStreamRunner(init_fn, step_fn, S,
                                        device="cpu").run(dets, masks)
    assert int(out_masks.sum()) > 0
    for t in range(T):
        np.testing.assert_array_equal(svc_outs[t].out_masks,
                                      out_masks[t].numpy())
        np.testing.assert_array_equal(svc_outs[t].outs[svc_outs[t].out_masks],
                                      outs[t].numpy()[out_masks[t].numpy()])


def test_service_slot_recycling_resets_ids():
    """A recycled slot starts over (the same first ids); a handle of the
    detached stream is stale; the JAX service gives the same ids."""
    frames = stream_frames(3, 4)

    def run(svc):
        h1 = svc.attach()
        ids = []
        for f in frames:
            svc.submit(h1, f)
            ids.append(sorted(svc.step().tracks_for(h1)[:, 4].tolist()))
        svc.detach(h1)
        with pytest.raises(ValueError, match="not attached"):
            svc.submit(h1, frames[0])
        h2 = svc.attach()
        assert h2.slot == h1.slot and h2.generation > h1.generation
        svc.submit(h2, frames[0])
        ids.append(sorted(svc.step().tracks_for(h2)[:, 4].tolist()))
        return ids

    got = run(port_service(n_streams=1))
    assert got[-1] == next(i for i in got if i)  # fresh state, same ids
    assert got == run(jax_service(n_streams=1))


def test_service_embedding_path():
    """Precomputed embeddings through the mux into DeepOC-SORT, one
    frame with a non-finite embedding row (zeroed at ingest)."""
    rng = np.random.default_rng(5)
    ticks = []
    for t in range(5):
        dets, embs = frame(rng, 3, emb_dim=8)
        if t == 3:
            embs[1] = np.nan
        ticks.append({0: (dets, {"embs": embs})})
    kw = dict(emb_dim=8, tracker_kw=dict(min_hits=1, embedding_off=False,
                                         cmc_off=True))
    assert_same_drive(drive(port_service("deepocsort", **kw), 1, ticks),
                      drive(jax_service("deepocsort", **kw), 1, ticks))


def test_service_threaded_producers():
    S, T = 4, 12
    svc = port_service(n_streams=S)
    handles = [svc.attach() for _ in range(S)]
    streams = [stream_frames(20 + s, T) for s in range(S)]
    errs = []

    def feed(s):
        try:
            for f in streams[s]:
                svc.submit(handles[s], f)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=feed, args=(s,)) for s in range(S)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errs
    assert svc.stats()["submitted"] == S * T

    consumed = 0
    for _ in range(T + 2):  # queue_depth=4 < T: drop-oldest applies
        consumed += int(svc.step().present.sum())
    stats = svc.stats()
    assert consumed == S * T - stats["dropped"]
    assert svc.step().present.sum() == 0  # drained


def test_service_warp_leg():
    """with_warps: identity warps equal the no-warp service within the
    corner round trip's rounding; a real warp moves the boxes; a
    non-finite warp counts as the identity; the JAX service emits the
    same."""
    frames = stream_frames(9, 5, n=2)
    kw = dict(tracker_kw=dict(with_reid=False), n_streams=1)
    shift = np.asarray([[1, 0, 30], [0, 1, 0]], np.float32)
    bad = np.full((2, 3), np.nan, np.float32)

    def ticks(warp=None):
        return [{0: (f, {} if warp is None else {"warp": warp})}
                for f in frames]

    plain = drive(port_service("botsort", **kw), 1, ticks())
    ident = drive(port_service("botsort", with_warps=True, **kw), 1, ticks())
    for (_, a), (_, b) in zip(plain, ident):
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-3)
    nan_warp = drive(port_service("botsort", with_warps=True, **kw), 1,
                     ticks(bad))
    for (_, a), (_, b) in zip(ident, nan_warp):
        np.testing.assert_array_equal(a[0], b[0])
    warped = drive(port_service("botsort", with_warps=True, **kw), 1,
                   ticks(shift))
    assert not np.allclose(np.concatenate([r[0][:, :4] for _, r in plain[1:]]),
                           np.concatenate([r[0][:, :4]
                                           for _, r in warped[1:]]))
    assert_same_drive(warped, drive(jax_service("botsort", with_warps=True,
                                                **kw), 1, ticks(shift)))


def test_service_combined_embs_and_warps():
    """The with_embs AND with_warps branch (BoT-SORT with ReID + CMC)."""
    rng = np.random.default_rng(3)
    shift = np.asarray([[1, 0, 4], [0, 1, 0]], np.float32)
    ticks = []
    for t in range(5):
        dets, embs = frame(rng, 3, emb_dim=8)
        dets[:, [0, 2]] += 4.0 * t
        ticks.append({0: (dets, {"embs": embs, "warp": shift})})
    kw = dict(n_streams=2, emb_dim=8, tracker_kw=dict(with_reid=True),
              with_warps=True)
    got = drive(port_service("botsort", **kw), 1, ticks)
    assert all(np.isfinite(rows[0]).all() for _, rows in got)
    assert_same_drive(got, drive(jax_service("botsort", **kw), 1, ticks))


# ---------------------------------------------------------------------------
# state: failover, migration, no aliasing
# ---------------------------------------------------------------------------


def test_service_states_restore_failover():
    """svc.states -> a fresh service's restore, in memory: the stream
    continues bit for bit across the failover; another tracker's state,
    or a state of another size, is refused."""
    frames = stream_frames(17, 10)
    ref = port_service()
    h = ref.attach()
    ref_rows = []
    for f in frames:
        ref.submit(h, f)
        ref_rows.append(ref.step().tracks_for(h))

    a = port_service()
    ha = a.attach()
    got_rows = []
    for f in frames[:5]:
        a.submit(ha, f)
        got_rows.append(a.step().tracks_for(ha))
    snap = a.states
    del a

    b = port_service()
    hb = b.attach()  # marks the slot for reset...
    b.restore(snap)
    b._reset[:] = False  # ...which the restored state supersedes
    for f in frames[5:]:
        b.submit(hb, f)
        got_rows.append(b.step().tracks_for(hb))
    assert len(got_rows) == len(ref_rows)
    for x, y in zip(got_rows, ref_rows):
        np.testing.assert_array_equal(x, y)

    # numpy fields are accepted too, and copied
    b.restore(type(snap)(*(t.numpy() for t in snap)))
    assert_state_equal(b.states, snap)
    with pytest.raises(ValueError, match="structure"):
        port_service("sort", tracker_kw=dict(min_hits=1)).restore(snap)
    with pytest.raises(ValueError, match="shape"):
        port_service(n_streams=3).restore(snap)


def test_service_restore_from_live_pytree_does_not_alias():
    """Restoring B from A's live carry copies it: stepping both services
    afterwards gives the same rows, and no field of B's carry shares
    storage with A's."""
    frames = stream_frames(23, 8)
    a = port_service()
    ha = a.attach()
    for f in frames[:4]:
        a.submit(ha, f)
        a.step()
    b = port_service()
    hb = b.attach()
    b.restore(a._shards[0].states)
    b._reset[:] = False
    assert all(x.data_ptr() != y.data_ptr()
               for x, y in zip(a._shards[0].states, b._shards[0].states))
    for f in frames[4:]:
        a.submit(ha, f)
        b.submit(hb, f)
        np.testing.assert_array_equal(a.step().tracks_for(ha),
                                      b.step().tracks_for(hb))


def test_service_states_property_survives_step():
    """``svc.states`` is a copy: a step after reading it leaves it as it
    was, and it shares no storage with the live carry."""
    frames = stream_frames(29, 4)
    svc = port_service()
    h = svc.attach()
    for f in frames[:3]:
        svc.submit(h, f)
        svc.step()
    snap = svc.states
    kept = type(snap)(*(t.clone() for t in snap))
    assert all(x.data_ptr() != y.data_ptr()
               for x, y in zip(snap, svc._shards[0].states))
    svc.submit(h, frames[3])
    svc.step()
    assert_state_equal(snap, kept)


def migration_frames(n0=0):
    return [np.array([[10 + 2 * f, 10, 50 + 2 * f, 90, 0.9, 0],
                      [200, 200 + 3 * f, 260, 320 + 3 * f, 0.85, 0]],
                     np.float32)
            for f in range(n0, n0 + 8)]


def test_stream_migration():
    """export_stream / import_stream move ONE camera between services
    mid-stream with bit-exact continuation; structure and shape
    mismatches raise."""
    ref = port_service()
    h = ref.attach()
    ref_outs = []
    for d in migration_frames():
        ref.submit(h, d)
        ref_outs.append(ref.step().tracks_for(h))

    svc1 = port_service()
    h1 = svc1.attach()
    got = []
    for d in migration_frames()[:4]:
        svc1.submit(h1, d)
        got.append(svc1.step().tracks_for(h1))
    snap = svc1.export_stream(h1)
    assert all(isinstance(x, np.ndarray) for x in snap)

    svc2 = port_service()
    other = svc2.attach()  # an unrelated stream in slot 0: isolation
    svc2.submit(other, np.array([[500, 500, 600, 700, 0.9, 0]], np.float32))
    svc2.step()
    h2 = svc2.attach()
    svc2.import_stream(h2, snap)
    for d in migration_frames()[4:]:
        svc2.submit(h2, d)
        got.append(svc2.step().tracks_for(h2))
    for a, b in zip(ref_outs, got):
        np.testing.assert_array_equal(a, b)

    with pytest.raises(ValueError, match="structure"):
        svc2.import_stream(h2, {"nope": np.zeros(3)})
    shaped = type(snap)(*(np.zeros(np.shape(a) + (1,), a.dtype)
                          for a in snap))
    with pytest.raises(ValueError, match="shape"):
        svc2.import_stream(h2, shaped)


def test_stream_migration_from_the_jax_package():
    """A stream exported by the JAX service, converted with the tracker's
    ``state_from_numpy``, continues in the port's service as it does in
    the JAX service."""
    from motcpp_tpu_torch.models.bytetrack import state_from_numpy

    ref = jax_service()
    h = ref.attach()
    want = []
    for d in migration_frames():
        ref.submit(h, d)
        want.append(ref.step().tracks_for(h))

    src = jax_service()
    hs = src.attach()
    for d in migration_frames()[:4]:
        src.submit(hs, d)
        src.step()
    jsnap = src.export_stream(hs)
    one = state_from_numpy({k: np.asarray(v)[None]
                            for k, v in jsnap._asdict().items()},
                           device="cpu")
    dst = port_service()
    dst.attach()
    hd = dst.attach()
    dst.import_stream(hd, type(one)(*(t[0] for t in one)))
    got = []
    for d in migration_frames()[4:]:
        dst.submit(hd, d)
        got.append(dst.step().tracks_for(hd))
    for g, w in zip(got, want[4:]):
        assert g.shape[0] > 0
        assert_same_rows(g, w)


# ---------------------------------------------------------------------------
# live ReID (crops leg)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def embeds():
    """The JAX package's BN-folded embed and the port's fused embed, of
    one osnet_x0_25 (feature_dim 16) at 32x16."""
    jmodel = jax_osnet(feature_dim=DIM)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = state_dict_from_flax(variables)
    model = infer_osnet(sd)
    model.load_state_dict(sd)
    return (jax_embed_fn(jmodel, variables, folded=True),
            make_embed_fn(model, fused=True, device="cpu"))


def live_service(embed, n_streams=2, **kw):
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort

    init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG), device="cpu")
    return TrackingService(init_fn, step_fn, n_streams=n_streams, max_dets=8,
                           emb_dim=DIM, device="cpu", crop_hw=HW,
                           embed_fn=embed, **kw)


def jax_live_service(embed, n_streams=2, **kw):
    from motcpp_tpu.models.botsort import BotSortConfig, make_botsort

    init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG))
    return JaxService(init_fn, step_fn, n_streams=n_streams, max_dets=8,
                      emb_dim=DIM, devices=jax.devices()[:1], crop_hw=HW,
                      embed_fn=embed, **kw)


def crop_ticks(seed, T, n_streams=1, n=3):
    """Per tick, every stream's (dets, crops) submission."""
    rng = np.random.default_rng(seed)
    return [{s: (frame(rng, n), {"crops": rng.integers(
        0, 255, (n,) + HW + (3,)).astype(np.uint8)})
        for s in range(n_streams)} for _ in range(T)]


def test_service_live_reid_matches_precomputed(embeds):
    """The crops-in service (the CNN on the device each tick) emits what
    the precomputed-embeddings service emits when fed the port's
    features of the same crops; the JAX live service emits the same."""
    jembed, embed = embeds
    ticks = crop_ticks(11, 6)
    live = drive(live_service(embed), 1, ticks)
    pre_ticks = [{0: (d, {"embs": embed(torch.from_numpy(kw["crops"]))
                          .numpy()})} for d, kw in (t[0] for t in ticks)]
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort

    init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG), device="cpu")
    pre = drive(TrackingService(init_fn, step_fn, n_streams=2, max_dets=8,
                                emb_dim=DIM, device="cpu"), 1, pre_ticks)
    assert_same_drive(live, pre, box_atol=0)
    assert_same_drive(live, drive(jax_live_service(jembed), 1, ticks),
                      LIVE_BOX_ATOL)


def test_service_crop_budget_matches_uncapped(embeds):
    """A crop_budget covering the tick's valid detections emits the same
    tracks as the uncapped live service, as in the JAX package; a budget
    without live ReID raises."""
    jembed, embed = embeds
    ticks = crop_ticks(13, 5)
    capped = drive(live_service(embed, crop_budget=3), 1, ticks)
    assert_same_drive(capped, drive(live_service(embed), 1, ticks), 1e-5)
    assert_same_drive(capped, drive(jax_live_service(jembed, crop_budget=3),
                                    1, ticks), LIVE_BOX_ATOL)
    with pytest.raises(ValueError, match="crop_budget"):
        port_service(crop_budget=4)


def test_cadence_compact_transfer_bit_exact(embeds):
    """Sending only the slots scheduled to embed this tick emits bit for
    bit what the full transfer emits; two ticks dispatched with
    step_async before either is resolved equal two step() calls; the
    JAX service emits the same."""
    jembed, embed = embeds
    k, S = 2, 4
    a = live_service(embed, n_streams=S, emb_cadence=k, cadence_compact=True)
    b = live_service(embed, n_streams=S, emb_cadence=k, cadence_compact=False)
    j = jax_live_service(jembed, n_streams=S, emb_cadence=k)
    assert a._cad_compact and not b._cad_compact and j._cad_compact
    hs = {svc: [svc.attach() for _ in range(S)] for svc in (a, b, j)}
    got = 0
    ticks = crop_ticks(7, 2 * k + 2, n_streams=S)
    for t0 in range(0, len(ticks), 2):
        results = {}
        for svc in (a, b, j):
            pend = []
            for sub in ticks[t0:t0 + 2]:
                for s, (d, kw) in sub.items():
                    svc.submit(hs[svc][s], d, **kw)
                # a: two ticks in flight, then both resolved
                pend.append(svc.step_async() if svc is a else svc.step())
            results[svc] = [p.result() if svc is a else p for p in pend]
        for ra, rb, rj in zip(results[a], results[b], results[j]):
            np.testing.assert_array_equal(ra.outs, rb.outs)
            np.testing.assert_array_equal(ra.out_masks, rb.out_masks)
            np.testing.assert_array_equal(ra.out_masks, rj.out_masks)
            m = ra.out_masks
            assert_same_rows(ra.outs[m], rj.outs[m], LIVE_BOX_ATOL)
            got += int(m.sum())
    assert got > 0
    with pytest.raises(ValueError, match="cadence_compact"):
        live_service(embed, n_streams=3, emb_cadence=2, cadence_compact=True)


def test_service_priority_budget_matches_uncapped(embeds):
    """emb_priority with a budget covering every valid crop emits bit for
    bit what the plain live service emits (the priority only orders the
    selection); the previous tick's dets are carried; the JAX priority
    service emits the same."""
    jembed, embed = embeds
    S, N = 2, 8
    ticks = crop_ticks(13, 6)
    pri = live_service(embed, crop_budget=S * N, emb_priority=True)
    got = drive(pri, 1, ticks)
    assert pri._shards[0].prev_dm is not None  # novelty baseline carried
    assert_same_drive(got, drive(live_service(embed), 1, ticks), box_atol=0)
    assert_same_drive(got, drive(jax_live_service(
        jembed, crop_budget=S * N, emb_priority=True), 1, ticks),
        LIVE_BOX_ATOL)


def test_priority_mode_holds_copies_of_the_mux_buffers(embeds):
    """The previous tick's dets and masks that the priority mode holds
    are copies: the next assemble overwrites the mux's buffers, and the
    held tensors keep the values of their own tick."""
    _, embed = embeds
    svc = live_service(embed, crop_budget=8, emb_priority=True)
    h = svc.attach()
    (d0, kw0), (d1, kw1) = (t[0] for t in crop_ticks(3, 2))
    svc.submit(h, d0, **kw0)
    svc.step()
    held = svc._shards[0].prev_dm
    assert not any(np.shares_memory(t.numpy(), buf) for t in held
                   for buf in (svc.mux._dets, svc.mux._mask))
    want = [t.clone() for t in held]
    np.testing.assert_array_equal(held[0][h.slot, :3].numpy(), d0)
    svc.submit(h, d1, **kw1)
    svc.step()  # assembles tick 1 into the same buffers
    np.testing.assert_array_equal(svc.mux._dets[h.slot, :3], d1)
    assert all(torch.equal(x, y) for x, y in zip(held, want))
    np.testing.assert_array_equal(
        svc._shards[0].prev_dm[0][h.slot, :3].numpy(), d1)


# ---------------------------------------------------------------------------
# validation, observability
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    "crop_hw_without_embed_fn", "embed_fn_without_emb_dim",
    "cadence_without_live_reid", "priority_without_budget",
    "priority_with_cadence", "compact_not_divisible",
])
def test_service_validation_errors(embeds, case):
    """The argument checks of the JAX service, raised as it raises them."""
    _, embed = embeds
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort

    init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG), device="cpu")
    base = dict(n_streams=2, max_dets=8, emb_dim=DIM, device="cpu")
    live = dict(crop_hw=HW, embed_fn=embed)
    kw, match = {
        "crop_hw_without_embed_fn": (dict(crop_hw=HW), "go together"),
        "embed_fn_without_emb_dim": (dict(live, emb_dim=0), "feature width"),
        "cadence_without_live_reid": (dict(emb_cadence=2), "emb_cadence"),
        "priority_without_budget": (dict(live, emb_priority=True),
                                    "crop_budget"),
        "priority_with_cadence": (dict(live, crop_budget=16, emb_cadence=4,
                                       emb_priority=True), "replaces"),
        "compact_not_divisible": (dict(live, n_streams=3, emb_cadence=2,
                                       cadence_compact=True),
                                  "cadence_compact"),
    }[case]
    with pytest.raises(ValueError, match=match):
        TrackingService(init_fn, step_fn, **{**base, **kw})


def test_service_stats_latency_gauges():
    """stats() exposes tick latency (last/ewma/max) and occupancy beside
    the mux counters; the service runs on the native mux."""
    svc = port_service(n_streams=4, tracker_kw=dict(max_tracks=8))
    assert isinstance(svc.mux, StreamMux)
    h = svc.attach()
    s0 = svc.stats()
    assert s0["ticks"] == 0 and s0["tick_ms_last"] == 0.0
    for f in range(3):
        svc.submit(h, np.array([[10 + f, 10, 50 + f, 90, 0.9, 0]],
                               np.float32))
        svc.step()
    s = svc.stats()
    assert s["ticks"] == 3 and s["submitted"] == 3 and s["assembled"] == 3
    assert s["tick_ms_last"] > 0 and s["tick_ms_max"] >= s["tick_ms_last"]
    assert s["tick_ms_ewma"] > 0
    assert s["occupancy"] == 0.25  # 1 live of 4 slots


# ---------------------------------------------------------------------------
# abuse (tests/test_serving_abuse.py through the port)
# ---------------------------------------------------------------------------

# generous CPU bound per tick; the point is "no runaway or crash"
TICK_BUDGET_S = 30.0


def _service(lap="jv", n_streams=2, max_dets=16):
    return TrackingService.from_tracker(
        "bytetrack", n_streams=n_streams, max_dets=max_dets,
        tracker_kw=dict(max_tracks=32, lap_impl=lap), device="cpu")


def _tick(svc, h, dets):
    svc.submit(h, dets)
    t0 = time.time()
    batch = svc.step()
    assert time.time() - t0 < TICK_BUDGET_S
    rows = batch.tracks_for(h)
    assert np.isfinite(rows).all(), rows
    return rows


def test_nan_inf_detections_survive():
    """NaN/inf coordinates and confidences neither crash the step nor
    leak non-finite values into emissions; the JAX service emits the
    same rows."""
    rng = np.random.default_rng(0)
    frames = []
    for t in range(8):
        d = np.zeros((6, 6), np.float32)
        d[:, 0] = rng.uniform(0, 500, 6)
        d[:, 1] = rng.uniform(0, 300, 6)
        d[:, 2] = d[:, 0] + 50
        d[:, 3] = d[:, 1] + 100
        d[:, 4] = 0.9
        if t % 2:
            d[0, 0] = np.nan
            d[1, 4] = np.inf
            d[2, 2] = -np.inf
            d[3, :4] = np.nan
        frames.append(d)
    svc = _service()
    h = svc.attach()
    got = [_tick(svc, h, d) for d in frames]
    jsvc = JaxService.from_tracker(
        "bytetrack", n_streams=2, max_dets=16,
        tracker_kw=dict(max_tracks=32, lap_impl="jv"),
        devices=jax.devices()[:1])
    hj = jsvc.attach()
    for g, d in zip(got, frames):
        jsvc.submit(hj, d)
        assert_same_rows(g, jsvc.step().tracks_for(hj))


def test_degenerate_boxes_survive():
    """Zero-area, inverted (x2 < x1), and hugely out-of-frame boxes."""
    svc = _service()
    h = svc.attach()
    cases = [
        [[10, 10, 10, 10, 0.9, 0]],              # zero area
        [[100, 100, 50, 40, 0.9, 0]],            # inverted
        [[-1e8, -1e8, 1e8, 1e8, 0.9, 0]],        # absurd extent
        [[0, 0, 1e-6, 1e-6, 0.99, 0]],           # sub-pixel
        [[5000, 5000, 5060, 5200, 0.9, 0]],      # far outside frame
    ]
    for c in cases:
        for _ in range(3):
            _tick(svc, h, np.asarray(c, np.float32))


@pytest.mark.parametrize("lap", ["jv", "auction", "auction_pallas"])
def test_near_tie_cost_flood(lap):
    """Many near-identical boxes make an all-near-tie cost matrix, the
    worst case for the auction's bidding war: every tick completes
    within the budget with a valid assignment, for every solver (the
    kernel's route runs its plain version on the CPU)."""
    svc = _service(lap=lap, max_dets=16)
    h = svc.attach()
    rng = np.random.default_rng(1)
    base = np.asarray([200.0, 150.0, 260.0, 330.0], np.float32)
    for t in range(6):
        d = np.zeros((16, 6), np.float32)
        d[:, :4] = base + rng.uniform(-0.5, 0.5, (16, 4)).astype(np.float32)
        d[:, 4] = 0.9 + rng.uniform(-1e-4, 1e-4, 16).astype(np.float32)
        rows = _tick(svc, h, d)
        assert rows.shape[0] <= 16  # never more tracks than dets


def test_sustained_overflow_drop_oldest():
    """Producers outpacing the stepper: overflow drops the OLDEST frame,
    the dropped counter advances, and the stream stays live."""
    svc = _service()
    h = svc.attach()
    depth = svc.mux.queue_depth
    for burst in range(3):
        for i in range(depth * 4):  # 4x oversubmit
            x = 10.0 + 3 * i
            svc.submit(h, np.asarray([[x, 10, x + 60, 130, 0.9, 0]],
                                     np.float32))
        assert svc.pending(h) == depth
        t0 = time.time()
        batch = svc.step()
        assert time.time() - t0 < TICK_BUDGET_S
        assert np.isfinite(batch.tracks_for(h)).all()
    stats = svc.stats()
    assert stats["dropped"] >= 3 * depth * 3  # 3 bursts x 3*depth evicted
    assert stats["submitted"] == 3 * depth * 4


def test_attach_detach_storm_with_stale_handles():
    """Rapid attach/detach cycling: stale handles are rejected, slots
    recycle cleanly, and live streams keep tracking."""
    svc = _service(n_streams=2)
    stale = []
    for cycle in range(6):
        h = svc.attach()
        svc.submit(h, np.asarray([[10, 10, 70, 130, 0.9, 0]], np.float32))
        svc.step()
        svc.detach(h)
        stale.append(h)
    h = svc.attach()
    for s in stale:
        if s.slot == h.slot:
            with pytest.raises(ValueError, match="stale"):
                svc.submit(s, np.zeros((0, 6), np.float32))
    rows = _tick(svc, h, np.asarray([[10, 10, 70, 130, 0.9, 0]],
                                    np.float32))
    assert rows.shape[1] == 8


def test_empty_and_all_low_conf_frames():
    """Empty frames and all-below-threshold frames age tracks without
    emitting garbage."""
    svc = _service()
    h = svc.attach()
    good = np.asarray([[10, 10, 70, 130, 0.9, 0]], np.float32)
    for _ in range(3):
        _tick(svc, h, good)
    assert _tick(svc, h, np.zeros((0, 6), np.float32)).shape[0] <= 1
    low = np.asarray([[10, 10, 70, 130, 0.02, 0]], np.float32)
    for _ in range(3):
        rows = _tick(svc, h, low)
        assert (rows[:, 5] > 0.02).all() if rows.shape[0] else True
