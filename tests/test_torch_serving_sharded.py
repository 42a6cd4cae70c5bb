"""Port parity: TrackingService sharded over devices, against the JAX
package's service over its 8 CPU devices and against the port's
one-device service, on the same submissions.

The port shards over ``devices=["cpu"] * n`` (n shards of slots on the
one CPU device); the JAX service over ``jax.devices()[:n]``. Against
JAX, presence, masks, ids, classes and detection indices are identical,
confidences agree at rtol 1e-5 and boxes within 1e-3 px (1e-4 px under
live ReID), as in tests/test_torch_serving.py; inside the port a
sharded service emits what the one-device service emits, bit for bit,
wherever the JAX package's does (everywhere but at a crop budget that
binds), and a state or a stream moves between the two layouts and
continues bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu.serving import TrackingService as JaxService
from motcpp_tpu_torch.serving import TrackingService
from test_torch_serving import (  # noqa: F401  (embeds is a fixture)
    BOX_ATOL,
    DIM,
    HW,
    LIVE_BOX_ATOL,
    LIVE_CFG,
    assert_same_drive,
    assert_same_rows,
    crop_ticks,
    drive,
    embeds,
    port_service,
    stream_frames,
)


def cpus(n):
    return None if n is None else ["cpu"] * n


def sharded_port_service(n, tracker="bytetrack", n_streams=8, **kw):
    return port_service(tracker, n_streams=n_streams, devices=cpus(n), **kw)


def sharded_jax_service(n, tracker="bytetrack", n_streams=8, max_dets=8,
                        emb_dim=0, tracker_kw=None, **kw):
    return JaxService.from_tracker(
        tracker, n_streams=n_streams, max_dets=max_dets, emb_dim=emb_dim,
        tracker_kw={"max_tracks": 16, **(tracker_kw or {})},
        devices=jax.devices()[:n], **kw)


def live_pair(n, embed, n_streams, port=True, **kw):
    """BoT-SORT live ReID (osnet_x0_25 at 32x16, emb_dim 16): the port's
    service over n CPU shards (None: one device), or the JAX service over
    n devices."""
    if port:
        from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort

        init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG),
                                        device="cpu")
        return TrackingService(init_fn, step_fn, n_streams=n_streams,
                               max_dets=8, emb_dim=DIM, device="cpu",
                               devices=cpus(n), crop_hw=HW, embed_fn=embed,
                               **kw)
    from motcpp_tpu.models.botsort import BotSortConfig, make_botsort

    init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG))
    return JaxService(init_fn, step_fn, n_streams=n_streams, max_dets=8,
                      emb_dim=DIM, devices=jax.devices()[:n], crop_hw=HW,
                      embed_fn=embed, **kw)


def irregular_ticks(S, T=5):
    """tests/test_serving.py:322's schedule: stream s submits frame t
    unless (t + s) % 3 == 0."""
    frames = {s: stream_frames(40 + s, T) for s in range(S)}
    return [{s: (frames[s][t], {}) for s in range(S) if (t + s) % 3}
            for t in range(T)]


def serve(svc, n_handles, ticks):
    """The whole batches of ``ticks`` (as tests/test_torch_serving.py's
    drive submits them)."""
    hs = [svc.attach() for _ in range(n_handles)]
    out = []
    for sub in ticks:
        for i, (d, kw) in sub.items():
            svc.submit(hs[i], d, **kw)
        out.append(svc.step())
    return out


def assert_same_batches(got, want):
    """Two port services' batches, bit for bit."""
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.present, b.present)
        np.testing.assert_array_equal(a.out_masks, b.out_masks)
        np.testing.assert_array_equal(a.outs, b.outs)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_service_sharded_matches_single_device_and_jax(n_dev):
    """ByteTrack on 8 slots sharded over n devices under irregular
    arrival: the one-device service bit for bit, the JAX service over n
    devices within the field tolerances (tests/test_serving.py:322)."""
    S = 8
    ticks = irregular_ticks(S)
    sharded = sharded_port_service(n_dev)
    assert sharded.devices == (torch.device("cpu"),) * n_dev
    got = serve(sharded, S, ticks)
    assert_same_batches(got, serve(sharded_port_service(None), S, ticks))
    assert_same_drive(drive(sharded_port_service(n_dev), S, ticks),
                      drive(sharded_jax_service(n_dev), S, ticks))


@pytest.mark.parametrize("direction", ["one_to_sharded", "sharded_to_one"])
def test_stream_migration_across_layouts(direction):
    """A stream exported from a one-device service continues bit for bit
    in a service sharded over 8 devices, and the other way round; the
    JAX package's migration into a sharded service emits the same
    (tests/test_serving.py:841)."""
    src_n, dst_n = (None, 8) if direction == "one_to_sharded" else (8, None)

    def frame(f):
        return np.array([[10 + 2 * f, 10, 50 + 2 * f, 90, 0.9, 0]],
                        np.float32)

    def migrate(make_src, make_dst):
        src, ref = make_src(), make_src()
        hs, hr = src.attach(), ref.attach()
        for f in range(4):
            src.submit(hs, frame(f))
            src.step()
            ref.submit(hr, frame(f))
            ref.step()
        dst = make_dst()
        for _ in range(5):  # land the stream on a slot of a later shard
            dst.attach()
        hd = dst.attach()
        dst.import_stream(hd, src.export_stream(hs))
        rows, want = [], []
        for f in range(4, 8):
            dst.submit(hd, frame(f))
            ref.submit(hr, frame(f))
            rows.append(dst.step().tracks_for(hd))
            want.append(ref.step().tracks_for(hr))
        return rows, want

    rows, want = migrate(lambda: sharded_port_service(src_n),
                         lambda: sharded_port_service(dst_n))
    for a, b in zip(rows, want):
        np.testing.assert_array_equal(a, b)
    assert sum(r.shape[0] for r in rows) > 0
    if direction == "one_to_sharded":
        jrows, _ = migrate(lambda: sharded_jax_service(1),
                           lambda: sharded_jax_service(8))
        for a, b in zip(rows, jrows):
            assert_same_rows(a, b)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
@pytest.mark.parametrize("direction", ["sharded_to_one", "one_to_sharded"])
def test_checkpoint_failover_across_layouts(tmp_path, direction, fmt):
    """A service state saved to a file from a sharded service restores
    into a one-device service, and the other way round, and continues
    the uninterrupted run bit for bit."""
    from motcpp_tpu_torch.utils.checkpoint import load_state, save_state

    S, T, cut = 8, 8, 4
    ticks = [{s: (f, {}) for s, f in enumerate(fs)} for fs in zip(
        *(stream_frames(60 + s, T) for s in range(S)))]
    src_n, dst_n = (4, None) if direction == "sharded_to_one" else (None, 4)
    want = serve(sharded_port_service(src_n), S, ticks)
    first = sharded_port_service(src_n)
    serve(first, S, ticks[:cut])
    path = tmp_path / f"state.{fmt}"
    save_state(first.states, path)
    second = sharded_port_service(dst_n)
    template = second._init_states()
    assert template.mean.shape[0] == S
    hs = [second.attach() for _ in range(S)]
    second.restore(load_state(template, path))
    got = []
    for sub in ticks[cut:]:
        for i, (d, _) in sub.items():
            second.submit(hs[i], d)
        got.append(second.step())
    assert_same_batches(got, want[cut:])
    assert_same_batches(want, serve(sharded_port_service(dst_n), S, ticks))


def test_service_live_reid_sharded_matches_precomputed(embeds):
    """The crops-in service over 2 shards emits what the one-device
    precomputed-embeddings service emits when fed the port's features,
    and what the JAX live service over 2 devices emits
    (tests/test_serving.py:616, n_dev=2)."""
    jembed, embed = embeds
    ticks = crop_ticks(11, 6)
    live = drive(live_pair(2, embed, 4), 1, ticks)
    pre_ticks = [{0: (d, {"embs": embed(torch.from_numpy(kw["crops"]))
                          .numpy()})} for d, kw in (t[0] for t in ticks)]
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort

    init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG), device="cpu")
    pre = drive(TrackingService(init_fn, step_fn, n_streams=4, max_dets=8,
                                emb_dim=DIM, device="cpu"), 1, pre_ticks)
    assert_same_drive(live, pre, box_atol=0)
    assert_same_drive(live, drive(live_pair(2, jembed, 4, port=False), 1,
                                  ticks), LIVE_BOX_ATOL)


def test_cadence_compact_sharded_bit_exact(embeds):
    """Cadence 2 over 2 shards of 4 slots: the compacted transfer (each
    shard's scheduled slots only) emits bit for bit what the full
    transfer and the one-device service emit, two step_async ticks in
    flight equal two step() calls, and the JAX service over 2 devices
    emits the same (tests/test_serving.py:950, n_dev=2)."""
    jembed, embed = embeds
    k, S = 2, 8
    a = live_pair(2, embed, S, emb_cadence=k, cadence_compact=True)
    b = live_pair(2, embed, S, emb_cadence=k, cadence_compact=False)
    one = live_pair(None, embed, S, emb_cadence=k)
    j = live_pair(2, jembed, S, port=False, emb_cadence=k)
    assert a._cad_compact and not b._cad_compact and j._cad_compact
    hs = {svc: [svc.attach() for _ in range(S)] for svc in (a, b, one, j)}
    ticks = crop_ticks(7, 2 * k + 2, n_streams=S)
    got = 0
    for t0 in range(0, len(ticks), 2):
        results = {}
        for svc in (a, b, one, j):
            pend = []
            for sub in ticks[t0:t0 + 2]:
                for s, (d, kw) in sub.items():
                    svc.submit(hs[svc][s], d, **kw)
                pend.append(svc.step_async() if svc is a else svc.step())
            results[svc] = [p.result() if svc is a else p for p in pend]
        for ra, rb, r1, rj in zip(*(results[x] for x in (a, b, one, j))):
            for other in (rb, r1):
                np.testing.assert_array_equal(ra.outs, other.outs)
                np.testing.assert_array_equal(ra.out_masks, other.out_masks)
            np.testing.assert_array_equal(ra.out_masks, rj.out_masks)
            m = ra.out_masks
            assert_same_rows(ra.outs[m], rj.outs[m], LIVE_BOX_ATOL)
            got += int(m.sum())
    assert got > 0


def test_service_priority_budget_sharded_matches_uncapped(embeds):
    """A priority budget covering every crop over 2 shards emits what the
    plain one-device live service emits, bit for bit, and what the JAX
    priority service over 2 devices emits; each shard carries its
    previous tick's dets (tests/test_serving.py:1008, n_dev=2)."""
    jembed, embed = embeds
    S, N = 4, 8
    ticks = crop_ticks(13, 6)
    pri = live_pair(2, embed, S, crop_budget=S * N, emb_priority=True)
    got = drive(pri, 1, ticks)
    assert all(sh.prev_dm is not None for sh in pri._shards)
    assert_same_drive(got, drive(live_pair(None, embed, S), 1, ticks),
                      box_atol=0)
    assert_same_drive(got, drive(live_pair(2, jembed, S, port=False,
                                           crop_budget=S * N,
                                           emb_priority=True), 1, ticks),
                      LIVE_BOX_ATOL)


@pytest.mark.parametrize("priority", [False, True])
def test_binding_budget_is_per_shard_as_in_jax(embeds, priority):
    """At a crop budget that binds (4 of the 9 crops each tick submits,
    2 a shard), the port's service over 2 shards emits what the JAX
    service over 2 devices emits."""
    jembed, embed = embeds
    S = 4
    ticks = crop_ticks(17, 6, n_streams=3)
    kw = dict(crop_budget=4, emb_priority=priority)
    assert_same_drive(drive(live_pair(2, embed, S, **kw), 3, ticks),
                      drive(live_pair(2, jembed, S, port=False, **kw), 3,
                            ticks), LIVE_BOX_ATOL)


@pytest.mark.parametrize("case", [
    "streams_do_not_divide", "budget_does_not_divide",
    "compact_shard_does_not_divide", "device_contradicts_devices"])
def test_sharded_service_validation_errors(embeds, case):
    """The JAX service's checks over devices, in its words, and a
    ``device`` that names another device than ``devices[0]``; the
    compacted transfer is off by default where a shard's slots do not
    divide by the cadence, as in the JAX service."""
    _, embed = embeds
    kw, match = {
        "streams_do_not_divide": (dict(n_streams=6), "n_streams=6 must "
                                  "divide evenly over 4 devices"),
        "budget_does_not_divide": (dict(crop_budget=6), "crop_budget=6 must "
                                   "divide evenly over 4 devices"),
        "compact_shard_does_not_divide": (dict(emb_cadence=4,
                                               cadence_compact=True),
                                          "cadence_compact"),
        "device_contradicts_devices": (dict(device="meta"), "contradicts"),
    }[case]
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort

    init_fn, step_fn = make_botsort(BotSortConfig(**LIVE_CFG), device="cpu")
    args = {"n_streams": 8, "max_dets": 8, "emb_dim": DIM,
            "devices": cpus(4), "crop_hw": HW, "embed_fn": embed, **kw}
    with pytest.raises(ValueError, match=match):
        TrackingService(init_fn, step_fn, **args)
    if case == "compact_shard_does_not_divide":
        args.pop("cadence_compact")
        assert not TrackingService(init_fn, step_fn, **args)._cad_compact
        assert TrackingService(init_fn, step_fn,
                               **dict(args, devices=None, device="cpu")
                               )._cad_compact


def test_sharded_service_makes_each_fresh_state_once():
    """A sharded service makes the reset select's fresh state once for
    each device, not once a tick on ``devices[0]`` (a copy between cards
    every tick); the one-device service still calls ``init_fn(S)`` every
    tick. Slots detached and attached again, so reset on later ticks,
    give the one-device service's batches bit for bit."""
    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )

    S, T = 8, 6
    ticks = irregular_ticks(S, T)

    def run(devices):
        init_fn, step_fn = make_bytetrack(
            ByteTrackConfig(max_tracks=16, max_dets=8), device="cpu")
        calls = []

        def counted(n):
            calls.append(n)
            return init_fn(n)

        svc = TrackingService(counted, step_fn, n_streams=S, max_dets=8,
                              device="cpu", devices=devices)
        hs = [svc.attach() for _ in range(S)]
        batches, per_tick = [], []
        for t, sub in enumerate(ticks):
            if t == 3:  # two slots start over: reset on the next tick
                for i in (1, 6):
                    svc.detach(hs[i])
                    hs[i] = svc.attach()
            for i, (d, kw) in sub.items():
                svc.submit(hs[i], d, **kw)
            n = len(calls)
            batches.append(svc.step())
            per_tick.append(calls[n:])
        return batches, per_tick

    one, one_calls = run(None)
    sharded, sharded_calls = run(cpus(2))
    assert_same_batches(sharded, one)
    assert all(c[-1:] == [S] for c in one_calls)
    assert sharded_calls[0] == [S // 2] * 2  # the shards' first states
    assert not any(sharded_calls[1:])
