"""Port parity: the XYSR Kalman filter, oriented-box IoU, the SORT step,
its host wrapper (AABB and OBB), the eval CLI and the multi-stream runner
of motcpp_tpu_torch against the JAX package on the same seeded inputs.

Integer state, masks and ids must be identical; float state and outputs
are compared at rtol 1e-5 (atol 0), as in tests/test_torch_bytetrack.py:
the two sides do the same float32 operations in the same order, but XLA
may fuse a multiply and an add into one rounding. Boxes emitted by the
runners are compared to 1e-3 px.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.models.sort import Sort as JaxSort
from motcpp_tpu.models.sort import SortConfig as JaxConfig
from motcpp_tpu.models.sort import make_sort as jax_make
from motcpp_tpu.ops import iou as jiou
from motcpp_tpu.ops.kalman import xysr as jxysr
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.sort import SortConfig, make_sort
from motcpp_tpu_torch.ops import iou
from motcpp_tpu_torch.ops.kalman import xysr
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from test_torch_golden import check_goldens

import torch_threads  # noqa: F401  (torch at one thread)

INT_FIELDS = ("active", "tid", "det_ind", "hits", "tsu", "age", "next_id",
              "frame_count")
FLOAT_FIELDS = ("x", "P", "ang", "conf", "cls")


def close(got, want, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=atol)


def xysr_states(rng, n):
    """Seeded XYSR measurements, and states a few predicts and updates
    old with nonzero velocities and a full covariance."""
    z = np.stack([rng.uniform(50, 900, n), rng.uniform(50, 500, n),
                  rng.uniform(500, 20000, n), rng.uniform(0.3, 0.8, n)],
                 -1).astype(np.float32)
    x, P = jxysr.xysr_init(jnp.asarray(z))
    for _ in range(3):
        x, P = jxysr.xysr_predict(x, P)
        zn = z + rng.normal(0, [3, 3, 200, 0.02], z.shape).astype(np.float32)
        x, P = jxysr.xysr_update(x, P, jnp.asarray(zn))
    return z, np.array(x), np.array(P)


@pytest.mark.parametrize("scaling", [(1.0, 1.0), (0.01, 0.0001)],
                         ids=["sort", "ocsort"])
def test_xysr_predict_update_match_jax(scaling):
    rng = np.random.default_rng(0)
    z, x, P = xysr_states(rng, 9)
    jp = jxysr.XYSRParams(*scaling)
    p = xysr.XYSRParams(*scaling)
    x0, P0 = xysr.xysr_init(torch.from_numpy(z), p)
    jx0, jP0 = jxysr.xysr_init(jnp.asarray(z), jp)
    close(x0, jx0)
    close(P0, jP0)
    got = xysr.xysr_predict(torch.from_numpy(x), torch.from_numpy(P), p)
    want = jxysr.xysr_predict(jnp.asarray(x), jnp.asarray(P), jp)
    close(got[0], want[0])
    close(got[1], want[1])
    z2 = z + rng.normal(0, 4, z.shape).astype(np.float32)
    got = xysr.xysr_update(got[0], got[1], torch.from_numpy(z2), p)
    want = jxysr.xysr_update(want[0], want[1], jnp.asarray(z2), jp)
    close(got[0], want[0])
    close(got[1], want[1], atol=1e-5)  # near-zero cross terms
    np.testing.assert_array_equal(got[1].numpy(),
                                  got[1].transpose(-1, -2).numpy())


def test_xysr_apply_affine_matches_jax():
    rng = np.random.default_rng(1)
    _, x, P = xysr_states(rng, 7)
    ang = rng.uniform(-0.1, 0.1, 7)
    m = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                  np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    m = (m * rng.uniform(0.95, 1.05, (7, 1, 1))).astype(np.float32)
    t = rng.normal(0, 5, (7, 2)).astype(np.float32)
    got = xysr.xysr_apply_affine(*(torch.from_numpy(a) for a in (x, P, m, t)))
    want = jxysr.xysr_apply_affine(*(jnp.asarray(a) for a in (x, P, m, t)))
    close(got[0], want[0], atol=1e-4)
    close(got[1], want[1], atol=1e-3)


# (box a, box b, expected IoU or None): [cx, cy, w, h, angle]
OBB_PAIRS = {
    "disjoint": ([0, 0, 10, 10, 0.3], [50, 0, 10, 10, 1.0], 0.0),
    "touching": ([0, 0, 10, 10, 0.0], [10, 0, 10, 10, 0.0], 0.0),
    "contained": ([0, 0, 20, 20, 0.0], [0, 0, 10, 10, math.pi / 4], 0.25),
    "identical": ([3, 4, 30, 12, 0.7], [3, 4, 30, 12, 0.7], 1.0),
    "0deg": ([0, 0, 20, 10, 0.0], [5, 0, 20, 10, 0.0], 15 / 25),
    # a square and itself turned 45 degrees: an octagon of 200 (sqrt2 - 1)
    "45deg": ([0, 0, 10, 10, 0.0], [0, 0, 10, 10, math.pi / 4], 2 ** -0.5),
    "90deg": ([0, 0, 40, 10, 0.0], [0, 0, 40, 10, math.pi / 2], 100 / 700),
}


@pytest.mark.parametrize("case", sorted(OBB_PAIRS))
def test_iou_obb_pair_cases_match_jax(case):
    a, b, want = OBB_PAIRS[case]
    a, b = np.float32([a]), np.float32([b])
    got = iou.iou_batch_obb(torch.from_numpy(a), torch.from_numpy(b))
    jgot = jiou.iou_batch_obb(jnp.asarray(a), jnp.asarray(b))
    close(got, jgot, atol=1e-6)
    assert abs(float(got[0, 0]) - want) < 1e-4


def test_iou_batch_obb_matches_jax_on_random_boxes():
    rng = np.random.default_rng(2)

    def boxes(n):
        return np.stack([rng.uniform(0, 200, n), rng.uniform(0, 200, n),
                         rng.uniform(10, 80, n), rng.uniform(10, 80, n),
                         rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)

    a, b = boxes(3 * 7).reshape(3, 7, 5), boxes(3 * 9).reshape(3, 9, 5)
    got = iou.iou_batch_obb(torch.from_numpy(a), torch.from_numpy(b))
    want = jiou.iou_batch_obb(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (3, 7, 9)
    close(got, want, atol=1e-5)
    assert float(got.max()) > 0.1 and float(got.min()) == 0.0


def scene(S=4, T=16, N=8, n_obj=6, seed=0):
    """synth_stream_dets plus dets below SORT's det_thresh and a gap
    longer than max_age, so births, deaths and the filter all occur."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.2
    dets[..., 4] = np.where(low, rng.uniform(0.1, 0.29, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[8:11, 0] = False
    return dets, masks


def assert_state_equal(state, jstate):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=2e-3 if name == "x" else 0,
                                   err_msg=name)


@pytest.mark.parametrize("lap", ["jv", "auction"])
def test_step_matches_jax_frame_by_frame(lap):
    """x at atol 2e-3: the synthetic objects keep their size, so the
    scale innovation w*h - s is near zero, and XLA computes it as one
    fused multiply-add where PyTorch rounds w*h first; the scale velocity
    then differs by up to one float32 ulp of the scale (0.002 at 2^14 to
    2^15 px^2) times the gain."""
    cfg = dict(max_tracks=16, max_dets=8, max_age=2, min_hits=2, lap_impl=lap)
    dets, masks = scene()
    S = dets.shape[1]
    jinit, jstep = jax_make(JaxConfig(**cfg))
    jstep = jax.jit(jax.vmap(jstep))
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    init, step = make_sort(SortConfig(**cfg), device="cpu")
    state = init(S)
    for t in range(dets.shape[0]):
        jstate, (jout, jmask) = jstep(jstate, jnp.asarray(dets[t]),
                                      jnp.asarray(masks[t]))
        state, (out, mask) = step(state, torch.from_numpy(dets[t]),
                                  torch.from_numpy(masks[t]))
        assert_state_equal(state, jstate)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=0)
    assert int(state.next_id.max()) > 6  # deaths and rebirths happened


def obb_scene(T=20, n=4):
    """n rotating, translating oriented boxes, two of them crossing, one
    missing for three frames; per frame (n, 7) rows."""
    frames = []
    for t in range(T):
        rows = []
        for k in range(n):
            if k == 3 and 8 <= t < 11:
                continue
            cx = 200 + 150 * k + 4.0 * t - (12.0 * t if k == 1 else 0.0)
            cy = 300 + 40 * k + 2.0 * t
            rows.append([cx, cy, 120, 50, 0.3 * k + 0.05 * t, 0.9, k % 2])
        frames.append(np.array(rows, np.float32))
    return frames


def test_obb_wrapper_matches_jax_wrapper():
    img = np.zeros((1080, 1920, 3), np.uint8)
    kw = dict(max_tracks=16, max_dets=8, min_hits=1, max_age=2)
    tr = create_tracker("sort", device="cpu", **kw)
    jtr = JaxSort(**kw)
    frames = obb_scene()
    for dets in frames:
        got, want = tr.update(dets, img), np.asarray(jtr.update(dets, img))
        assert got.shape == want.shape and got.shape[1] == 9
        np.testing.assert_array_equal(got[:, 5:], want[:, 5:])
        np.testing.assert_allclose(got[:, :5], want[:, :5], atol=1e-3)
    assert tr.is_obb and tr.cfg.is_obb
    assert tr.update(np.zeros((0, 7), np.float32), img).shape == (0, 9)
    tr.reset()
    tr.update(frames[0], img)
    assert tr.cfg.is_obb


def test_aabb_wrapper_matches_jax_wrapper():
    dets, masks = scene(S=1, T=12, seed=3)
    img = np.zeros((480, 640, 3), np.uint8)
    tr = create_tracker("sort", max_tracks=16, max_dets=8, device="cpu")
    jtr = JaxSort(max_tracks=16, max_dets=8)
    for t in range(dets.shape[0]):
        d = dets[t, 0][masks[t, 0]]
        got, want = tr.update(d, img), np.asarray(jtr.update(d, img))
        assert got.shape == want.shape and got.shape[1] == 8
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    assert not tr.cfg.is_obb


@pytest.mark.parametrize("which", ["golden", "golden_long"])
def test_port_cli_writes_sort_goldens(which, tmp_path):
    check_goldens("sort", which, tmp_path)


@pytest.mark.parametrize("lap", ["jv", "auction_pallas"])
def test_runner_at_bench_config_matches_jax_runner(lap):
    """bench.py's SORT config (min_hits=1, max_age=3; bench.py:66-76)."""
    S, K, N, T = 8, 16, 8, 20
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N, n_obj=6)
    cfg = dict(min_hits=1, max_age=3, max_tracks=K, max_dets=N, lap_impl=lap)
    jinit, jstep = jax_make(JaxConfig(**cfg))
    jrunner = JaxRunner(jinit, jstep, S, devices=jax.devices()[:1])
    init, step = make_sort(SortConfig(**cfg), device="cpu")
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


def obb_stream_scene(S=4, T=20, N=8, n=4):
    """obb_scene's rotating boxes over S streams, each stream shifted
    and turned: dets (T, S, N, 7) [cx, cy, w, h, angle, conf, cls] and
    masks (T, S, N); box 1 crosses the others, and stream 0's box 3 is
    missing for three frames."""
    dets = np.zeros((T, S, N, 7), np.float32)
    masks = np.zeros((T, S, N), bool)
    for t in range(T):
        for s in range(S):
            for k in range(n):
                cx = (200 + 150 * k + 30 * s + 4.0 * t
                      - (12.0 * t if k == 1 else 0.0))
                cy = 300 + 40 * k + 20 * s + 2.0 * t
                dets[t, s, k] = [cx, cy, 120, 50, 0.3 * k + 0.05 * t
                                 + 0.1 * s, 0.9, k % 2]
                masks[t, s, k] = not (s == 0 and k == 3 and 8 <= t < 11)
    return dets, masks


@pytest.mark.parametrize("lap", ["jv", "auction"])
def test_obb_runner_matches_jax_vmapped_step(lap):
    """The stream-batched OBB step under MultiStreamRunner, from its
    first 7-column frame, in two run() calls, against the JAX package's
    vmapped OBB step frame by frame, at
    test_step_matches_jax_frame_by_frame's tolerances."""
    cfg = dict(max_tracks=16, max_dets=8, max_age=3, min_hits=1,
               lap_impl=lap, is_obb=True)
    dets, masks = obb_stream_scene()
    T, S = dets.shape[:2]
    jinit, jstep = jax_make(JaxConfig(**cfg))
    jstep = jax.jit(jax.vmap(jstep))
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    jouts, jmasks = [], []
    for t in range(T):
        jstate, (jout, jmask) = jstep(jstate, jnp.asarray(dets[t]),
                                      jnp.asarray(masks[t]))
        jouts.append(np.asarray(jout))
        jmasks.append(np.asarray(jmask))
    init, step = make_sort(SortConfig(**cfg), device="cpu")
    runner = MultiStreamRunner(init, step, S, device="cpu")
    parts = [runner.run(dets[sl], masks[sl])
             for sl in (slice(0, 7), slice(7, T))]
    outs = torch.cat([p[0] for p in parts]).numpy()
    out_masks = torch.cat([p[1] for p in parts]).numpy()
    assert outs.shape == (T, S, 16, 9)
    np.testing.assert_array_equal(out_masks, np.stack(jmasks))
    np.testing.assert_allclose(outs, np.stack(jouts), rtol=1e-5, atol=0)
    assert_state_equal(runner.states, jstate)
    assert out_masks[0].sum() == 4 * S  # every box born on frame 1
    assert out_masks[8:11, 0].sum(-1).tolist() == [3, 3, 3]  # the dropout
