"""Port parity: state checkpoint files of motcpp_tpu_torch
(``utils/checkpoint.py``) against the JAX package's.

Inside the port, a tracker, a runner and a service resume bit for bit
from a file in either format (``.npz`` in the JAX package's layout, or
a torch file), for all nine trackers; a file of another structure,
shape or dtype raises ValueError. Across packages, a ``.npz`` service
state written by the JAX package continues in the port's service as it
does in the JAX service, and the port's in the JAX service, with the
serving tolerances of tests/test_torch_serving.py (masks and ids equal,
boxes within 1e-4 px). The cadence tick is not in a checkpoint in
either package: a fresh service restarts it at 0, so a restore
continues bit for bit only at a cut that is a multiple of the cadence.
"""

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu.utils import checkpoint as jax_ckpt
from motcpp_tpu_torch.models.sort import Sort
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from motcpp_tpu_torch.utils.checkpoint import (
    load_state,
    load_tracker,
    save_state,
    save_tracker,
)
from test_torch_serving import (  # noqa: F401  (embeds is a fixture)
    LIVE_BOX_ATOL,
    TRACKER_KW,
    assert_same_rows,
    assert_state_equal,
    crop_ticks,
    embeds,
    jax_live_service,
    jax_service,
    live_service,
    port_service,
    stream_frames,
)

IMG = np.zeros((480, 640, 3), np.uint8)
FORMATS = ["npz", "pt"]


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_aux.py::test_checkpoint_roundtrip on the port, in both
    formats: two futures continued from one checkpoint are identical."""
    d = np.array([[100, 100, 200, 200, 0.9, 0]], np.float32)
    moved = np.array([[104, 104, 204, 204, 0.9, 0]], np.float32)
    for fmt in FORMATS:
        tr = Sort(min_hits=1, max_age=5, max_tracks=8, max_dets=4,
                  device="cpu")
        for _ in range(3):
            tr.update(d, IMG)
        save_tracker(tr, tmp_path / f"state.{fmt}")
        tr2 = Sort(min_hits=1, max_age=5, max_tracks=8, max_dets=4,
                   device="cpu")
        tr2.update(d, IMG)
        load_tracker(tr2, tmp_path / f"state.{fmt}")
        a, b = tr.update(moved, IMG), tr2.update(moved, IMG)
        assert a.shape[0] == 1
        np.testing.assert_array_equal(a, b)


def test_checkpoint_torch_file_roundtrip(tmp_path):
    """tests/test_aux.py::test_checkpoint_orbax_roundtrip with the torch
    file in place of orbax's directory: a suffix other than .npz, loaded
    into a tracker that has no state yet."""
    tr = Sort(min_hits=1, max_tracks=8, max_dets=4, device="cpu")
    tr.update(np.array([[100, 100, 200, 200, 0.9, 0]], np.float32), IMG)
    save_tracker(tr, tmp_path / "ckpt")
    tr2 = Sort(min_hits=1, max_tracks=8, max_dets=4, device="cpu")
    load_tracker(tr2, tmp_path / "ckpt")
    assert int(tr2._state.frame_count) == 1
    with pytest.raises(ValueError, match="no state"):
        save_tracker(Sort(device="cpu"), tmp_path / "none")


@pytest.mark.parametrize("fmt", FORMATS)
def test_service_checkpoint_failover(tmp_path, fmt):
    """tests/test_serving.py::test_service_checkpoint_failover (one
    device) on the port: svc.states -> file -> a fresh service's
    restore continues the stream bit for bit; a SORT service refuses
    the ByteTrack state."""
    frames = stream_frames(17, 10)
    path = tmp_path / f"svc.{fmt}"

    ref = port_service(n_streams=2)
    h = ref.attach()
    ref_rows = []
    for f in frames:
        ref.submit(h, f)
        ref_rows.append(ref.step().tracks_for(h))

    a = port_service(n_streams=2)
    ha = a.attach()
    got_rows = []
    for f in frames[:5]:
        a.submit(ha, f)
        got_rows.append(a.step().tracks_for(ha))
    save_state(a.states, path)

    b = port_service(n_streams=2)
    hb = b.attach()  # marks the slot for reset...
    template = b._init_states()
    b.restore(load_state(template, path))
    b._reset[:] = False  # ...which the restored checkpoint supersedes
    for f in frames[5:]:
        b.submit(hb, f)
        got_rows.append(b.step().tracks_for(hb))

    assert len(got_rows) == len(ref_rows)
    for x, y in zip(got_rows, ref_rows):
        np.testing.assert_array_equal(x, y)

    other = port_service(n_streams=2, tracker="sort",
                         tracker_kw=dict(min_hits=1))
    with pytest.raises(ValueError):
        other.restore(load_state(template, path))


@pytest.mark.parametrize("fmt", FORMATS)
def test_restore_supersedes_the_attach_reset(tmp_path, fmt):
    """The failover a user writes: attach, restore, step, with no reset
    flag touched by hand. The stream attached before the restore
    continues as the uninterrupted run; a slot attached after the
    restore starts fresh, as a new camera on a fresh service does."""
    frames = stream_frames(18, 8)
    path = tmp_path / f"svc.{fmt}"
    ref = port_service(n_streams=2)
    h = ref.attach()
    want = []
    for f in frames:
        ref.submit(h, f)
        want.append(ref.step().tracks_for(h))

    a = port_service(n_streams=2)
    ha = a.attach()
    for f in frames[:4]:
        a.submit(ha, f)
        a.step()
    save_state(a.states, path)

    b = port_service(n_streams=2)
    hb = b.attach()
    b.restore(load_state(b._init_states(), path))
    late = b.attach()
    fresh = port_service(n_streams=2)
    hf = fresh.attach()
    for f, w in zip(frames[4:], want[4:]):
        b.submit(hb, f)
        b.submit(late, f)
        fresh.submit(hf, f)
        out = b.step()
        np.testing.assert_array_equal(out.tracks_for(hb), w)
        np.testing.assert_array_equal(out.tracks_for(late),
                                      fresh.step().tracks_for(hf))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(TRACKER_KW))
def test_service_state_files_resume_bit_for_bit(tmp_path, name, fmt):
    """Every tracker's service state: the file reads back equal to the
    state field by field, and a fresh service restored from it emits,
    and ends in, what the uninterrupted service emits and ends in."""
    frames = stream_frames(5, 8, n=3)
    kw = dict(tracker_kw=TRACKER_KW[name])
    ref = port_service(name, **kw)
    h = ref.attach()
    want = []
    for t, f in enumerate(frames):
        ref.submit(h, f)
        want.append(ref.step().tracks_for(h))
        if t == 3:
            snap = ref.states
    path = tmp_path / f"{name}.{fmt}"
    save_state(snap, path)
    svc = port_service(name, **kw)
    hb = svc.attach()
    loaded = load_state(svc._init_states(), path)
    assert_state_equal(loaded, snap)
    svc.restore(loaded)
    svc._reset[:] = False
    for f, w in zip(frames[4:], want[4:]):
        svc.submit(hb, f)
        np.testing.assert_array_equal(svc.step().tracks_for(hb), w)
    assert sum(w.shape[0] for w in want[4:]) > 0
    assert_state_equal(svc.states, ref.states)


@pytest.mark.parametrize("fmt", FORMATS)
def test_runner_resumes_from_a_file_bit_for_bit(tmp_path, fmt):
    """MultiStreamRunner.set_states from a checkpoint file continues the
    rollout as the uninterrupted one."""
    from motcpp_tpu_torch.data import synth_stream_dets
    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )

    dets, masks = (torch.from_numpy(a) for a in synth_stream_dets(
        np.random.default_rng(0), 8, 3, 8, n_obj=5))
    init, step = make_bytetrack(ByteTrackConfig(max_tracks=16, max_dets=8),
                                device="cpu")
    ref = MultiStreamRunner(init, step, 3, device="cpu")
    want = ref.run(dets, masks)
    a = MultiStreamRunner(init, step, 3, device="cpu")
    a.run(dets[:4], masks[:4])
    save_state(a.states, tmp_path / f"r.{fmt}")
    b = MultiStreamRunner(init, step, 3, device="cpu")
    b.set_states(load_state(b.init_states(), tmp_path / f"r.{fmt}"))
    got = b.run(dets[4:], masks[4:])
    assert int(want[1][4:].sum()) > 0
    assert torch.equal(got[1], want[1][4:])
    assert torch.equal(got[0], want[0][4:])


@pytest.mark.parametrize("case", ["count", "names", "shape", "dtype"])
def test_mismatched_files_raise(tmp_path, case):
    """A file of another state type (field count or names), another
    stream count (shape) or another dtype raises ValueError, where the
    JAX package's loader fails later or not at all."""
    byte = port_service(n_streams=2)
    template = byte._init_states()
    if case == "count":
        path = tmp_path / "sort.npz"
        save_state(port_service("sort", n_streams=2)._init_states(), path)
    elif case == "names":
        path = tmp_path / "sort.pt"
        save_state(port_service("sort", n_streams=2)._init_states(), path)
    elif case == "shape":
        path = tmp_path / "three.npz"
        save_state(port_service(n_streams=3)._init_states(), path)
    else:
        path = tmp_path / "dtype.pt"
        fields = list(template)
        fields[0] = fields[0].to(torch.float64)
        save_state(type(template)(*fields), path)
    with pytest.raises(ValueError, match="mismatch"):
        load_state(template, path)


def test_npz_layout_is_the_jax_packages(tmp_path):
    """leaf_i in field order, with the JAX package's dtypes: the port's
    file of a service state loads through the JAX loader into the JAX
    service's template, field by field equal."""
    svc = port_service()
    h = svc.attach()
    for f in stream_frames(3, 4):
        svc.submit(h, f)
        svc.step()
    save_state(svc.states, tmp_path / "p.npz")
    jt = jax_service()._init_states()
    got = jax_ckpt.load_state(jt, tmp_path / "p.npz")
    with np.load(tmp_path / "p.npz") as data:
        assert data.files == [f"leaf_{i}" for i in range(len(svc.states))]
    for name, j, p in zip(svc.states._fields, jax.tree_util.tree_leaves(got),
                          svc.states):
        j = np.asarray(j)
        assert j.dtype == p.numpy().dtype and j.tobytes() == \
            p.numpy().tobytes(), name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_service_state_crosses_packages_and_continues(tmp_path, direction):
    """A .npz service state saved by one package, restored into the
    other's fresh service, continues the stream as the writer's service
    does: the restored state is stepped, not only compared."""
    frames = stream_frames(11, 10)
    path = tmp_path / "svc.npz"
    src = jax_service() if direction == "jax_to_port" else port_service()
    hs = src.attach()
    for f in frames[:5]:
        src.submit(hs, f)
        src.step()
    (jax_ckpt.save_state if direction == "jax_to_port" else save_state)(
        src.states, path)
    want = []
    for f in frames[5:]:
        src.submit(hs, f)
        want.append(src.step().tracks_for(hs))

    dst = port_service() if direction == "jax_to_port" else jax_service()
    hd = dst.attach()
    load = load_state if direction == "jax_to_port" else jax_ckpt.load_state
    dst.restore(load(dst._init_states(), path))
    dst._reset[:] = False
    for f, w in zip(frames[5:], want):
        dst.submit(hd, f)
        g = dst.step().tracks_for(hd)
        assert g.shape[0] > 0
        assert_same_rows(g, w, LIVE_BOX_ATOL)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_cadence_tick_is_not_in_a_checkpoint(tmp_path, embeds, package):
    """Live ReID at cadence k=2: the schedule (tick + slot) % k runs on
    the service's own tick count, which no state carries. In both
    packages a fresh service restored from a file continues the
    uninterrupted run bit for bit when cut at a multiple of k, and ends
    in another state when cut elsewhere (its tick restarts at 0)."""
    jembed, embed = embeds
    k, S, T = 2, 2, 8
    if package == "port":
        make = lambda: live_service(embed, n_streams=S, emb_cadence=k)  # noqa: E731
        save, load = save_state, load_state
    else:
        make = lambda: jax_live_service(jembed, n_streams=S,  # noqa: E731
                                        emb_cadence=k)
        save, load = jax_ckpt.save_state, jax_ckpt.load_state
    frames = stream_frames(9, T, n=3)
    crops = crop_ticks(4, T, n_streams=S)

    def feed(svc, hs, t):
        for s in range(S):
            d = frames[t].copy()
            d[:, :4] += 7.0 * s
            svc.submit(hs[s], d, **crops[t][s][1])
        return svc.step()

    def fields(states):
        return [np.asarray(x) for x in (
            states if package == "port" else jax.tree_util.tree_leaves(states))]

    ref = make()
    hs = [ref.attach() for _ in range(S)]
    want = [feed(ref, hs, t) for t in range(T)]
    same = {}
    for cut in (4, 3):
        a = make()
        ha = [a.attach() for _ in range(S)]
        for t in range(cut):
            feed(a, ha, t)
        save(a.states, tmp_path / f"c{cut}.npz")
        b = make()
        hb = [b.attach() for _ in range(S)]
        b.restore(load(b._init_states(), tmp_path / f"c{cut}.npz"))
        b._reset[:] = False
        got = [feed(b, hb, t) for t in range(cut, T)]
        same[cut] = all(np.array_equal(g.outs[g.out_masks], w.outs[w.out_masks])
                        and np.array_equal(g.out_masks, w.out_masks)
                        for g, w in zip(got, want[cut:]))
        same[cut] &= all(x.tobytes() == y.tobytes() for x, y in zip(
            fields(b.states), fields(ref.states)))
    assert int(sum(w.out_masks.sum() for w in want)) > 0
    assert same == {4: True, 3: False}
