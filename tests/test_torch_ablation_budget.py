"""Port parity: the ablation scoreboard's priority-budget probes
(``motcpp_tpu_torch/scripts/ablation_benchmark.py``) against the JAX
package's ``scripts/ablation_benchmark.py``, on the CPU at 150 frames:
bench.py's DEPLOYED budget points (StrongSORT at priority 0.6, HybridSORT
at 0.8) and the contrast that justifies the priority policy (StrongSORT
at half the detections by confidence). Every metric equal at the JAX
tool's rounding and the emitted rows frame for frame.

The JAX tool's priority comes from ``ablation_parity.jax_priority_table``
(one batched call of the JAX ``embedding_priority``), held here to the
tool's own per-frame eager calls bit for bit; the port's selection is held
to the JAX priority's on every frame of the scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import motcpp_tpu.parallel.streams as jax_streams
import torch_threads  # noqa: F401  (torch at one thread)
from ablation_parity import (
    FRAMES,
    both,
    first_difference,
    frame_inputs,
    jax_priority_table,
)
from motcpp_tpu.data.synthetic import ablation_scene
from motcpp_tpu_torch.scripts import ablation_benchmark as port_tool

# frames at which the batched table is held to the per-frame eager call:
# the first (no previous frame), the second, the middle and the last
EAGER_FRAMES = (1, 2, 75, 150)


@pytest.mark.parametrize("t", EAGER_FRAMES)
def test_batched_jax_priority_equals_the_per_frame_call(t):
    batch, table = jax_priority_table()
    _, dets, _, _ = ablation_scene(n_frames=FRAMES)
    args = frame_inputs(dets, t)
    eager = np.asarray(jax_streams.embedding_priority(
        *(jnp.asarray(a) for a in args), jnp.int32(t)))[0]
    pN = args[0].shape[1]
    assert np.array_equal(batch[0][t - 1, :pN], args[0][0])
    assert np.array_equal(table[t][:pN].view(np.int32), eager.view(np.int32))


@pytest.mark.parametrize("fraction", [0.6, 0.8])
def test_port_selection_is_the_jax_priority_selection(fraction):
    """On every frame the port's budget_select keeps the detections that
    the JAX tool's priority order keeps."""
    _, table = jax_priority_table()
    _, dets, _, _ = ablation_scene(n_frames=FRAMES)
    prev = None
    for t in range(1, FRAMES + 1):
        d_now = np.asarray(dets[t], np.float32).reshape(-1, 6)
        n = len(d_now)
        if n:
            got = port_tool.budget_select(d_now, prev, t, fraction,
                                          "priority", "cpu")
            C = max(1, int(np.ceil(fraction * n)))
            want = np.zeros(n, bool)
            want[np.argsort(-table[t][:n])[:C]] = True
            assert np.array_equal(got, want), t
        prev = d_now


@pytest.mark.parametrize("tracker,fraction,policy", [
    ("strongsort", 0.6, "priority"), ("hybridsort", 0.8, "priority"),
    ("strongsort", 0.5, "conf")])
def test_budget_point_equals_the_jax_tools(tracker, fraction, policy,
                                           monkeypatch):
    port, jax, port_out, jax_out = both(monkeypatch, [tracker],
                                        emb_budget=fraction,
                                        budget_policy=policy)
    assert port == jax
    assert first_difference(port_out[tracker], jax_out[tracker]) is None
