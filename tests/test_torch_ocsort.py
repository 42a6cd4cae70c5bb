"""Port parity: the select helpers, the IoU-family similarities, the
OC-SORT step, its host wrapper, the eval CLI and the multi-stream runner
of motcpp_tpu_torch against the JAX package on the same seeded inputs.

Integer state, masks and ids must be identical. Float state and outputs
are compared at rtol 1e-5, atol 0, as in tests/test_torch_bytetrack.py,
except where a test states why it needs more. Boxes emitted by the
runners are compared to 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.models.ocsort import OCSort as JaxOCSort
from motcpp_tpu.models.ocsort import OCSortConfig as JaxConfig
from motcpp_tpu.models.ocsort import make_ocsort as jax_make
from motcpp_tpu.ops import iou as jiou
from motcpp_tpu.ops import select as jselect
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.ocsort import OCSortConfig, make_ocsort
from motcpp_tpu_torch.ops import iou, select
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from test_torch_golden import check_goldens

import torch_threads  # noqa: F401  (torch at one thread)

INT_FIELDS = ("active", "tid", "age", "hits", "hit_streak", "tsu", "det_ind",
              "obs_age", "obs_ptr", "next_id", "frame_count")
FLOAT_FIELDS = ("x", "P", "conf", "cls", "last_obs", "velocity", "obs_ring")


def select_inputs(rng, S=3, K=6, N=5, R=4, D=3):
    """Seeded operands of every select helper, each with a leading
    stream dimension; indices include -1 and out-of-range values."""
    d2t = np.full((S, N), -1, np.int32)
    for s in range(S):  # one-to-one det -> track matchings
        k = rng.permutation(K)[:N]
        d2t[s] = np.where(rng.random(N) < 0.6, k, -1)
    return {
        "mat": rng.normal(size=(S, K, N)).astype(np.float32),
        "idx": rng.integers(-1, N + 1, (S, K)).astype(np.int32),
        "tab": rng.normal(size=(S, N, D)).astype(np.float32),
        "idx_in": rng.integers(0, N, (S, K)).astype(np.int32),
        "ring": rng.normal(size=(S, K, R, D)).astype(np.float32),
        "ring_s": rng.integers(0, 9, (S, K, R)).astype(np.int32),
        "slot": rng.integers(0, R, (S, K)).astype(np.int32),
        "new": rng.normal(size=(S, K, D)).astype(np.float32),
        "new_s": rng.integers(10, 20, (S, K)).astype(np.int32),
        "mask": rng.random((S, K)) < 0.5,
        "d2t": d2t,
        "rows": rng.random((S, K)) < 0.6,
        "cols": rng.random((S, N)) < 0.5,
        "col": rng.integers(0, N, (S, K)).astype(np.int32),
    }


SELECT_CALLS = {
    "take_per_row": lambda f, a: f.take_per_row(a["mat"], a["idx"]),
    "take_per_row_fill": lambda f, a: f.take_per_row(a["mat"], a["idx"],
                                                     fill=-7.0),
    # indices in range: every caller clips them (the port's contract)
    "gather_rows": lambda f, a: f.gather_rows(a["tab"], a["idx_in"]),
    "take_slot": lambda f, a: f.take_slot(a["ring"], a["slot"]),
    "write_slot": lambda f, a: f.write_slot(a["ring"], a["slot"], a["new"],
                                            a["mask"]),
    "write_slot_scalar": lambda f, a: f.write_slot_scalar(
        a["ring_s"], a["slot"], a["new_s"], a["mask"]),
    "invert_matching": lambda f, a: f.invert_matching(a["d2t"], 6),
    "rank_match": lambda f, a: f.rank_match(a["rows"], a["cols"]),
    "birth_slots": lambda f, a: f.birth_slots(a["rows"], a["cols"]),
    "set_at_col": lambda f, a: f.set_at_col(a["mat"], a["col"], 3.5),
}


@pytest.mark.parametrize("name", sorted(SELECT_CALLS))
def test_select_helpers_match_jax(name):
    a = select_inputs(np.random.default_rng(0))
    got = SELECT_CALLS[name](select, {k: torch.from_numpy(v)
                                      for k, v in a.items()})
    want = SELECT_CALLS[name](jselect, {k: jnp.asarray(v)
                                        for k, v in a.items()})
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
        if w.dtype.kind == "i":
            assert g.dtype == torch.int32


@pytest.mark.parametrize("mode", iou.ASSO_FUNCS)
def test_asso_functions_match_jax(mode):
    """Every similarity of get_asso_fn on boxes with overlaps, disjoint
    pairs and a zero-height box, with a leading stream dimension."""
    rng = np.random.default_rng(1)
    if mode.endswith("obb"):
        a = np.stack([rng.uniform(0, 300, (2, 7)), rng.uniform(0, 300, (2, 7)),
                      rng.uniform(10, 90, (2, 7)), rng.uniform(10, 90, (2, 7)),
                      rng.uniform(-3, 3, (2, 7))], -1).astype(np.float32)
        b = a[:, ::-1].copy()
        b[..., :2] += rng.normal(0, 20, b[..., :2].shape).astype(np.float32)
    else:
        xy = rng.uniform(0, 300, (2, 7, 2))
        a = np.concatenate([xy, xy + rng.uniform(5, 90, (2, 7, 2))], -1)
        b = a[:, ::-1] + rng.normal(0, 15, a.shape)
        a, b = a.astype(np.float32), b.astype(np.float32)
        a[0, 0, 3] = a[0, 0, 1]
    fn = iou.get_asso_fn(mode, 640, 480)
    jfn = jiou.get_asso_fn(mode, 640, 480)
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2, 7, 7)
    # atan, sqrt and the clip's divisions may round a last bit apart
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Invalid association mode"):
        iou.get_asso_fn("bogus")


def scene(S=4, T=18, N=8, n_obj=6, seed=0):
    """synth_stream_dets plus dets between min_conf and det_thresh (the
    BYTE stage's) and gaps long enough for the OCR rematch and deaths."""
    rng = np.random.default_rng(seed)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=n_obj)
    low = rng.random((T, S, N)) < 0.25
    dets[..., 4] = np.where(low, rng.uniform(0.11, 0.19, (T, S, N)),
                            dets[..., 4]).astype(np.float32)
    masks[6:9, 0, :3] = False
    masks[9:15, -1] = False
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


@pytest.mark.parametrize("use_byte", [False, True], ids=["ocr", "byte"])
def test_step_matches_jax_frame_by_frame(use_byte):
    """x at atol 2e-3, as in tests/test_torch_sort.py: the scale
    innovation of constant-size objects is near zero, and XLA rounds it
    as one fused multiply-add where PyTorch rounds the product first."""
    cfg = dict(max_tracks=16, max_dets=8, max_age=4, min_hits=2,
               use_byte=use_byte)
    dets, masks = scene()
    S = dets.shape[1]
    jinit, jstep = jax_make(JaxConfig(**cfg))
    jstep = jax.jit(jax.vmap(jstep))
    jstate = jax.vmap(lambda _: jinit())(jnp.arange(S))
    init, step = make_ocsort(OCSortConfig(**cfg), device="cpu")
    state = init(S)
    for t in range(dets.shape[0]):
        jstate, (jout, jmask) = jstep(jstate, jnp.asarray(dets[t]),
                                      jnp.asarray(masks[t]))
        state, (out, mask) = step(state, torch.from_numpy(dets[t]),
                                  torch.from_numpy(masks[t]))
        assert_state_equal(state, jstate)
        jmask = np.asarray(jmask)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        np.testing.assert_allclose(out.numpy()[jmask], np.asarray(jout)[jmask],
                                   rtol=1e-5, atol=0)
    assert int(state.next_id.max()) > 6  # deaths and rebirths happened
    assert int((state.obs_ptr > 3).sum()) > 0  # the ring wrapped


def test_wrapper_matches_jax_wrapper_with_centroid_similarity():
    """The centroid similarity takes the frame size of the first image."""
    dets, masks = scene(S=1, T=12, seed=3)
    img = np.zeros((720, 1280, 3), np.uint8)
    kw = dict(max_tracks=16, max_dets=8, asso_func="centroid",
              iou_threshold=0.9)
    tr = create_tracker("ocsort", device="cpu", **kw)
    jtr = JaxOCSort(**kw)
    n = 0
    for t in range(dets.shape[0]):
        d = dets[t, 0][masks[t, 0]]
        got, want = tr.update(d, img), np.asarray(jtr.update(d, img))
        assert got.shape == want.shape and got.shape[1] == 8
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
        n += len(got)
    assert (tr.cfg.frame_width, tr.cfg.frame_height) == (1280, 720)
    assert n > 0


@pytest.mark.parametrize("which", ["golden", "golden_long"])
def test_port_cli_writes_ocsort_goldens(which, tmp_path):
    check_goldens("ocsort", which, tmp_path)


@pytest.mark.parametrize("lap", ["jv", "auction_pallas"])
def test_runner_at_bench_config_matches_jax_runner(lap):
    """bench.py's OC-SORT config (min_hits=1; bench.py:86-95)."""
    S, K, N, T = 8, 16, 8, 20
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N, n_obj=6)
    cfg = dict(min_hits=1, max_tracks=K, max_dets=N, lap_impl=lap)
    jinit, jstep = jax_make(JaxConfig(**cfg))
    jrunner = JaxRunner(jinit, jstep, S, devices=jax.devices()[:1])
    init, step = make_ocsort(OCSortConfig(**cfg), device="cpu")
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
