"""Port parity: box, IoU, cost, linear-algebra and Kalman ops of
motcpp_tpu_torch against the JAX functions on the same seeded inputs.

Tolerance: rtol 1e-6 and atol 1e-5 in float32. The two sides round the
same operations, but XLA's CPU backend fuses some multiply-adds into one
rounding and may sum in another order, so results differ by a few ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.ops import boxes as jboxes
from motcpp_tpu.ops import iou as jiou
from motcpp_tpu.ops import linalg as jlinalg
from motcpp_tpu.ops import matching as jmatching
from motcpp_tpu.ops.kalman.gaussian import kf_xyah as jkf
from motcpp_tpu_torch.ops import boxes, iou, linalg, matching
from motcpp_tpu_torch.ops.kalman.gaussian import kf_xyah

import torch_threads  # noqa: F401  (torch at one thread)

RTOL, ATOL = 1e-6, 1e-5


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def random_xyxy(rng, shape):
    xy = rng.uniform(0, 1000, shape + (2,)).astype(np.float32)
    wh = rng.uniform(5, 200, shape + (2,)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def random_spd(rng, batch, n):
    a = rng.normal(size=batch + (n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


CONVERTERS = [
    "xyxy2xywh", "xywh2xyxy", "xywh2tlwh", "tlwh2xywh", "tlwh2xyxy",
    "xyxy2tlwh", "tlwh2xyah", "xyah2tlwh", "xywh2xyah", "xyah2xywh",
    "xyxy2xyah", "xyah2xyxy", "xyxy2xysr", "xysr2xyxy",
]


@pytest.mark.parametrize("name", CONVERTERS)
def test_box_converters_match_jax(name):
    rng = np.random.default_rng(0)
    x = random_xyxy(rng, (3, 17))
    x[0, :3, 3] = x[0, :3, 1]  # zero heights exercise the guards
    got = getattr(boxes, name)(torch.from_numpy(x))
    close(got, getattr(jboxes, name)(jnp.asarray(x)))


def test_iou_batch_matches_jax():
    rng = np.random.default_rng(1)
    a = random_xyxy(rng, (4, 9))
    b = random_xyxy(rng, (4, 7))
    b[:, 0] = a[:, 0]  # identical boxes: IoU exactly 1
    b[:, 1, 2:] = b[:, 1, :2]  # empty box
    got = iou.iou_batch(torch.from_numpy(a), torch.from_numpy(b))
    want = np.stack([np.asarray(jiou.iou_batch(jnp.asarray(a[s]),
                                               jnp.asarray(b[s])))
                     for s in range(4)])
    close(got, want)
    assert got.shape == (4, 9, 7)


def test_iou_distance_and_fuse_score_match_jax():
    rng = np.random.default_rng(2)
    a = random_xyxy(rng, (12,))
    b = random_xyxy(rng, (10,))
    conf = rng.uniform(0, 1, 10).astype(np.float32)
    dist = matching.iou_distance(torch.from_numpy(a), torch.from_numpy(b))
    jdist = jmatching.iou_distance(jnp.asarray(a), jnp.asarray(b))
    close(dist, jdist)
    close(matching.fuse_score(dist, torch.from_numpy(conf)),
          jmatching.fuse_score(jdist, jnp.asarray(conf)))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_closed_form_inverses_match_jax(n):
    rng = np.random.default_rng(10 + n)
    m = random_spd(rng, (6,), n)
    fn = {2: "inv2", 3: "inv3", 4: "inv4", 5: "inv5"}[n]
    got = getattr(linalg, fn)(torch.from_numpy(m))
    want = getattr(jlinalg, fn)(jnp.asarray(m))
    if n == 2:
        close(got[1], want[1])
        got, want = got[0], want[0]
    close(got, want)
    close(got @ torch.from_numpy(m), np.broadcast_to(np.eye(n), (6, n, n)))


@pytest.mark.parametrize("n", [2, 4, 5])
def test_solve_spd_and_matmul_small_match_jax(n):
    rng = np.random.default_rng(20 + n)
    S = random_spd(rng, (5,), n)
    B = rng.normal(size=(5, n, 3)).astype(np.float32)
    close(linalg.solve_spd(torch.from_numpy(S), torch.from_numpy(B)),
          jlinalg.solve_spd(jnp.asarray(S), jnp.asarray(B)))
    close(linalg.matmul_small(torch.from_numpy(S), torch.from_numpy(B)),
          jlinalg.matmul_small(jnp.asarray(S), jnp.asarray(B)))


def test_solve_spd_rejects_large_systems():
    with pytest.raises(ValueError):
        linalg.solve_spd(torch.eye(6), torch.ones(6, 1))


def test_kf_xyah_initiate_predict_update_match_jax():
    rng = np.random.default_rng(3)
    z0 = jboxes.xyxy2xyah(jnp.asarray(random_xyxy(rng, (2, 11))))
    z0 = np.array(z0)
    mean, cov = kf_xyah.initiate(torch.from_numpy(z0))
    jmean, jcov = jkf.initiate(jnp.asarray(z0))
    close(mean, jmean)
    close(cov, jcov)
    for step in range(6):
        mean, cov = kf_xyah.predict(mean, cov)
        jmean, jcov = jkf.predict(jmean, jcov)
        close(mean, jmean)
        close(cov, jcov)
        z = (z0 + rng.normal(0, 2, z0.shape) * [1, 1, 0.01, 1]).astype(np.float32)
        mean, cov = kf_xyah.update(mean, cov, torch.from_numpy(z))
        jmean, jcov = jkf.update(jmean, jcov, jnp.asarray(z))
        # the filters may drift apart by ulps; hand JAX's state back so
        # each step is compared on identical inputs
        close(mean, jmean)
        close(cov, jcov)
        mean = torch.from_numpy(np.array(jmean))
        cov = torch.from_numpy(np.array(jcov))
    pm, pc = kf_xyah.project(mean, cov)
    jpm, jpc = jkf.project(jnp.asarray(mean.numpy()), jnp.asarray(cov.numpy()))
    close(pm, jpm)
    close(pc, jpc)
