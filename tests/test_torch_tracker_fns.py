"""Port parity: the scoreboard's tracker builder
(``motcpp_tpu_torch/scripts/tracker_fns.py``) against the JAX package's
``bench.py::build_tracker_fns``.

For each of the nine trackers, one seeded rollout (S=4 streams, T=8
frames, K=16 track slots, N=8 detection slots, ``lap_impl
"auction_pallas"``: the Pallas kernel on the JAX side, the CUDA kernel's
plain version here) through the port's builder and runner emits what the
JAX builder emits through the JAX runner: identical masks, ids, classes
and detection indices, confidences at rtol 1e-5, boxes within 1e-3 px
(2e-3 for SORT and OC-SORT, whose x carries that tolerance in their
one-device tests). The configurations themselves, with and without an
embedding width, are held field by field.
"""

import dataclasses
import importlib
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from motcpp_tpu_torch.scripts.tracker_fns import (
    TRACKERS,
    build_tracker_fns,
    tracker_config,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402

S, T, K, N = 4, 8, 16, 8
BOX_ATOL = {"sort": 2e-3, "ocsort": 2e-3}


def bench_args(lap="auction_pallas", emb_dim=0):
    return types.SimpleNamespace(max_tracks=K, max_dets=N, lap=lap,
                                 emb_dim=emb_dim)


@pytest.mark.parametrize("tracker", TRACKERS)
def test_rollout_equals_the_jax_builders(tracker):
    dets, masks = synth_stream_dets(np.random.default_rng(3), T, S, N,
                                    n_obj=6)
    jinit, jstep = bench.build_tracker_fns(tracker, bench_args())
    wo, wm = (np.asarray(a) for a in JaxRunner(
        jinit, jstep, S, devices=jax.devices()[:1]).run(
            jnp.asarray(dets), jnp.asarray(masks)))
    init, step = build_tracker_fns(tracker, K, N, "auction_pallas",
                                   device="cpu")
    go, gm = (a.numpy() for a in MultiStreamRunner(
        init, step, S, device="cpu").run(dets, masks))
    np.testing.assert_array_equal(gm, wm)
    assert wm.sum() > 0
    got, want = go[gm], wo[wm]
    np.testing.assert_array_equal(got[:, [4, 6, 7]], want[:, [4, 6, 7]])
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=BOX_ATOL.get(tracker, 1e-3))


def _jax_config(tracker, args, monkeypatch):
    """The config bench.build_tracker_fns hands its tracker's factory."""
    seen = {}
    mod = importlib.import_module(f"motcpp_tpu.models.{tracker}")
    monkeypatch.setattr(mod, f"make_{tracker}",
                        lambda cfg: seen.setdefault("cfg", cfg))
    bench.build_tracker_fns(tracker, args)
    return seen["cfg"]


@pytest.mark.parametrize("emb_dim", [0, 24])
def test_configs_equal_the_jax_builders(emb_dim, monkeypatch):
    for tracker in TRACKERS:
        want = _jax_config(tracker, bench_args("jv", emb_dim), monkeypatch)
        make, got = tracker_config(tracker, K, N, "jv", emb_dim)
        assert make.__name__ == f"make_{tracker}"
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want), tracker


def test_unknown_tracker_raises():
    with pytest.raises(ValueError, match="unknown tracker"):
        tracker_config("deepsort")
