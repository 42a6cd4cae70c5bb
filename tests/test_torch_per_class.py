"""Port parity: the per-class wrapper of motcpp_tpu_torch routes classes
as the JAX package's does (tests/test_aux.py), and over the port's SORT,
ByteTrack and UCMCTrack emits the rows that the JAX wrapper emits over
the JAX trackers on a three-class scene."""

import numpy as np
import pytest

import motcpp_tpu
from motcpp_tpu.models.per_class import PerClassTracker as JaxPerClass
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.per_class import PerClassTracker

import torch_threads  # noqa: F401  (torch at one thread)


IMG = np.zeros((480, 640, 3), np.uint8)


def test_per_class_routing():
    """JAX tests/test_aux.py:10-41 on the port's SORT."""
    tr = PerClassTracker(lambda: create_tracker(
        "sort", min_hits=1, max_tracks=8, max_dets=4, device="cpu"),
        nr_classes=3)
    dets = np.array([[100, 100, 200, 200, 0.9, 0],
                     [105, 105, 205, 205, 0.9, 1],  # overlapping, other class
                     [400, 100, 500, 200, 0.8, 1]], np.float32)
    out = tr.update(dets, IMG)
    assert out.shape[0] == 3
    ids_by_cls = {}
    for r in out:
        ids_by_cls.setdefault(int(r[6]), set()).add(int(r[4]))
    # classes never share tracks despite the overlap
    assert len(ids_by_cls[0] & ids_by_cls[1]) == 0
    # id namespaces are disjoint by stride
    assert all(i < PerClassTracker.ID_STRIDE for i in ids_by_cls[0])
    assert all(i >= PerClassTracker.ID_STRIDE for i in ids_by_cls[1])
    # det_ind maps back to the unsplit rows
    assert sorted(int(r[7]) for r in out) == [0, 1, 2]
    tr.reset()
    assert tr.update(dets, IMG).shape[0] == 3


def three_class_scene(T=24, N=12, seed=0):
    """One stream of synth_stream_dets, the rows' classes 0, 1 and 2
    (objects keep their class), a quarter of the confidences at 0.3, a
    frame with no detections (frame 7), and class 2
    absent for four frames so that its tracker updates with empty input
    and ages."""
    dets, masks = synth_stream_dets(np.random.default_rng(seed), T, 1, N,
                                    n_obj=N)
    dets[..., 5] = (np.arange(N) % 3).astype(np.float32)
    low = np.random.default_rng(seed + 1).random((T, 1, N)) < 0.25
    dets[..., 4] = np.where(low, 0.3, dets[..., 4]).astype(np.float32)
    masks[7] = False
    masks[12:16, :, 2::3] = False
    return [dets[t, 0][masks[t, 0]] for t in range(T)]


@pytest.mark.parametrize("name,kw,box_atol", [
    ("sort", dict(min_hits=1, max_age=3), 1e-3), ("bytetrack", {}, 0),
    ("ucmctrack", {}, 0)])
def test_per_class_rows_match_jax(name, kw, box_atol):
    """Ids, confidences, classes and det_ind identical; SORT's boxes are
    its Kalman state, which XLA's fused scale innovation moves by an ulp
    (tests/test_torch_sort.py), so they agree to 1e-3 px there and to
    the bit elsewhere."""
    kw = dict(kw, max_tracks=16, max_dets=8)
    frames = three_class_scene()
    tr = PerClassTracker(lambda: create_tracker(name, device="cpu", **kw))
    jtr = JaxPerClass(lambda: motcpp_tpu.create_tracker(name, **kw))
    emitted = 0
    for t, dets in enumerate(frames):
        got, want = tr.update(dets, IMG), np.asarray(jtr.update(dets, IMG))
        assert got.shape == want.shape, t
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:],
                                      err_msg=f"frame {t}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                                   atol=box_atol, err_msg=f"frame {t}")
        emitted += got.shape[0]
    assert emitted > 0
    assert sorted(tr._trackers) == sorted(jtr._trackers) == [0, 1, 2]
