"""What the port's scoreboard tests (``tests/test_torch_bench*.py``)
share: the CLI's small sizes (``tests/test_bench.py``'s), the JAX
``bench.py`` argument namespace at those sizes, a runner class that keeps
its first rollout, and the comparison of a first rollout with the JAX
runner's (identical masks, ids, classes and detection indices,
confidences at rtol 1e-5, boxes within ``atol`` px)."""

import argparse

import numpy as np

SMALL = ["--cpu", "--streams", "8", "--frames", "4", "--repeats", "1",
         "--max-tracks", "16", "--max-dets", "8", "--objects", "4"]
KEYS = {"metric", "value", "unit", "vs_baseline"}
BOX_ATOL = {"sort": 2e-3}  # SORT's x, as tests/test_torch_tracker_fns.py


def recording(cls, store):
    """``cls`` whose run() keeps its first call's inputs and outputs."""

    class Recording(cls):
        def run(self, *a, **kw):
            out = cls.run(self, *a, **kw)
            store.setdefault("call", (a, kw, out))
            return out

    return Recording


def jax_bench_args(**kw):
    args = dict(streams=8, frames=4, repeats=1, max_tracks=16, max_dets=8,
                objects=4, lap="auction_pallas", emb_dim=0, cmc="",
                reid_variant="x1_0", dw_impl="conv", crop_budget=0,
                reid_quant=False, emb_priority=0.0, emb_cadence=0)
    args.update(kw)
    return argparse.Namespace(**args)


def same_first_rollout(got, want, atol):
    """Port outputs (torch) against JAX outputs (jax arrays)."""
    go, gm = (t.numpy() for t in got)
    wo, wm = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gm, wm)
    assert wm.sum() > 0
    g, w = go[gm], wo[wm]
    np.testing.assert_array_equal(g[:, [4, 6, 7]], w[:, [4, 6, 7]])
    np.testing.assert_allclose(g[:, 5], w[:, 5], rtol=1e-5, atol=0)
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=atol)
