"""Runs the ablation scoreboard in both packages for the port's tests.

``both(trackers, **probe)`` runs the port's
``motcpp_tpu_torch/scripts/ablation_benchmark.py::run_scoreboard`` on the
CPU and the JAX package's ``scripts/ablation_benchmark.py::run_scoreboard``
(imported as ``tests/test_accuracy_ablation.py`` imports it) at FRAMES
frames on the same scene, and returns both metric tables with each
tracker's emitted rows a frame, recorded by wrapping each package's
``create_tracker``.

The JAX tool's priority probes call ``embedding_priority`` eagerly once a
frame at a shape that changes from frame to frame, which costs about 0.7 s
a frame on the CPU (every operator compiled again for each shape).
``jax_priority_table`` evaluates the same function once for every frame
of the scene, each frame as one stream of a batch padded to PAD rows with
its own frame index; ``tests/test_torch_ablation_budget.py`` holds that
table to the per-frame eager calls bit for bit, and ``both`` hands the JAX
tool the table's rows in place of the per-frame calls.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

import motcpp_tpu
import motcpp_tpu.parallel.streams as jax_streams
import motcpp_tpu_torch
from motcpp_tpu.data.synthetic import ablation_scene
from motcpp_tpu_torch.scripts import ablation_benchmark as port_tool

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from scripts import ablation_benchmark as jax_tool  # noqa: E402

# the scene's minimum (data/synthetic.py::ablation_scene raises below it)
FRAMES = 150
PAD = 128  # rows of the batched priority table, above the scene's dets
# emitted boxes and confidences: XLA's fused multiply-adds against
# PyTorch's two roundings (ROADMAP queue 3) move the Kalman states and
# BoostTrack's boosted confidences in their last bits
BOX_ATOL, CONF_ATOL = 1e-3, 1e-5

_tables = {}


def frame_inputs(dets, t):
    """The JAX tool's inputs to embedding_priority at frame t, padded to
    ``max(n, len(prev), 1)`` rows as the tool pads them."""
    d_now = np.asarray(dets[t], np.float32).reshape(-1, 6)
    pd = (np.asarray(dets[t - 1], np.float32).reshape(-1, 6) if t > 1
          else np.zeros((0, 6), np.float32))
    n, pN = len(d_now), max(len(d_now), len(pd), 1)
    out = [np.zeros((1, pN, 6), np.float32), np.zeros((1, pN), bool),
           np.zeros((1, pN, 6), np.float32), np.zeros((1, pN), bool)]
    out[0][0, :n], out[1][0, :n] = d_now, True
    out[2][0, :len(pd)], out[3][0, :len(pd)] = pd, True
    return out


def jax_priority_table(n_frames=FRAMES):
    """{t: JAX embedding_priority of frame t's PAD rows}, from one eager
    call over all frames (frame t is stream t - 1, its index a (S, 1)
    int32 column)."""
    if n_frames not in _tables:
        _, dets, _, _ = ablation_scene(n_frames=n_frames)
        batch = [np.zeros((n_frames, PAD, 6), np.float32),
                 np.zeros((n_frames, PAD), bool),
                 np.zeros((n_frames, PAD, 6), np.float32),
                 np.zeros((n_frames, PAD), bool)]
        for t in range(1, n_frames + 1):
            for whole, part in zip(batch, frame_inputs(dets, t)):
                whole[t - 1, :part.shape[1]] = part[0]
        ts = np.arange(1, n_frames + 1, dtype=np.int32)[:, None]
        pri = np.asarray(jax_streams.embedding_priority(
            *(jnp.asarray(a) for a in batch), jnp.asarray(ts)))
        _tables[n_frames] = (batch, {t: pri[t - 1]
                                     for t in range(1, n_frames + 1)})
    return _tables[n_frames]


def recording(create, seen, **fixed):
    """``create`` (a package's create_tracker) whose trackers append each
    update()'s output to ``seen[model]``."""
    def make(model, **kw):
        tracker = create(model, **fixed, **kw)
        outs = seen.setdefault(model, [])
        update = tracker.update

        def recorded(*args, **kwargs):
            out = update(*args, **kwargs)
            outs.append(np.array(out))
            return out

        tracker.update = recorded
        return tracker
    return make


def both(monkeypatch, trackers, **probe):
    """(port metrics, JAX metrics, port rows, JAX rows) of ``trackers``
    at FRAMES frames under ``probe`` (run_scoreboard's keyword
    arguments); the rows are {model: [each frame's (M, 8) output]}."""
    port_rows, jax_rows = {}, {}
    monkeypatch.setattr(motcpp_tpu_torch, "create_tracker", recording(
        motcpp_tpu_torch.create_tracker, port_rows))
    monkeypatch.setattr(motcpp_tpu, "create_tracker", recording(
        motcpp_tpu.create_tracker, jax_rows))
    if probe.get("emb_budget") and probe.get("budget_policy",
                                             "priority") == "priority":
        batch, table = jax_priority_table()

        def from_table(d, m, pd, pm, t):
            n = d.shape[1]
            got = np.asarray(batch[0][int(t) - 1, :n])
            assert np.array_equal(np.asarray(d)[0], got), int(t)
            return jnp.asarray(table[int(t)][None, :n])

        monkeypatch.setattr(jax_streams, "embedding_priority", from_table)
    port = port_tool.run_scoreboard(FRAMES, trackers, progress=len,
                                    device="cpu", **probe)
    jax = jax_tool.run_scoreboard(FRAMES, trackers, progress=len, **probe)
    return port, jax, port_rows, jax_rows


def first_difference(got, want):
    """The first frame (1-based) whose emitted rows differ between two
    runs' outputs: in number, in ids, classes or detection indices, in
    boxes by more than BOX_ATOL or in confidences by more than CONF_ATOL;
    None where none does."""
    for t, (a, b) in enumerate(zip(got, want), 1):
        if (a.shape != b.shape
                or not np.array_equal(a[:, [4, 6, 7]], b[:, [4, 6, 7]])
                or np.abs(a[:, :4] - b[:, :4]).max(initial=0.0) > BOX_ATOL
                or np.abs(a[:, 5] - b[:, 5]).max(initial=0.0) > CONF_ATOL):
            return t
    return None if len(got) == len(want) else min(len(got), len(want)) + 1
