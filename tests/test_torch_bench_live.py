"""The port's live-ReID scoreboard leg (``motcpp_tpu_torch/bench.py::
bench_livereid``) against the JAX package's ``bench.py::bench_livereid``
on the CPU: BoT-SORT at cadence 8 with osnet_x0_25 at S=1 (T=4, N=16,
K=64, 256x128 crops), the JAX weights carried across by
``appearance/osnet.py::state_dict_from_flax``. The dets, masks and crops
(drawn from ``default_rng(0)``) are the JAX leg's, and the first rollout
(the warm-up) emits the JAX runner's masks, ids, classes and detection
indices, confidences at rtol 1e-5 and boxes within 1e-3 px (float32
module forwards on both sides; the auction kernel's plain version here,
the Pallas kernel in interpret mode there).
"""

import sys
from pathlib import Path

import numpy as np

import torch_threads  # noqa: F401  (torch at one thread)
from bench_parity import jax_bench_args, recording, same_first_rollout
from motcpp_tpu_torch import bench as port

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402


def test_live_leg_equals_bench_livereid(monkeypatch):
    """BoT-SORT at cadence 8, osnet_x0_25, S=1, float32 module forwards,
    the JAX weights carried across."""
    import jax
    import motcpp_tpu.appearance.reid as jax_reid
    import motcpp_tpu.parallel as jax_parallel
    from motcpp_tpu_torch.appearance.osnet import (
        infer_osnet,
        state_dict_from_flax,
    )

    # one device, as bench.py sees when it runs alone (S=1 does not
    # divide over the eight CPU devices of tests/conftest.py)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    seen, weights = {}, {}
    monkeypatch.setattr(jax_parallel, "MultiStreamRunner",
                        recording(jax_parallel.MultiStreamRunner, seen))
    make = jax_reid.make_embed_fn

    def recording_embed(model, variables, **kw):
        weights["variables"] = variables
        return make(model, variables, **kw)

    monkeypatch.setattr(jax_reid, "make_embed_fn", recording_embed)
    flags = dict(streams=1, reid_variant="x0_25", emb_cadence=8)
    want = bench.bench_livereid("botsort", jax_bench_args(**flags))
    (jdets, jmasks), jkw, jout = seen["call"]

    def carried(variant, feature_dim):
        sd = state_dict_from_flax(jax.device_get(weights["variables"]))
        model = infer_osnet(sd)
        model.load_state_dict(sd)
        return model.eval()

    monkeypatch.setattr(port, "reid_model", carried)
    report = {}
    args = port.parser().parse_args(
        ["--cpu", "--tracker", "botsort", "--livereid", "--streams", "1",
         "--reid-variant", "x0_25", "--emb-cadence", "8", "--repeats", "1"])
    got = port.bench_livereid("botsort", args, report=report)
    S, dets, masks, host_kw = report["inputs"]
    np.testing.assert_array_equal(dets, np.asarray(jdets))
    np.testing.assert_array_equal(masks, np.asarray(jmasks))
    np.testing.assert_array_equal(host_kw["crops0"],
                                  np.asarray(jkw["embs"])[0])
    same_first_rollout(report["first"], jout, 1e-3)
    assert got["metric"] == "torch_" + want["metric"]
    assert set(got) == set(want)
