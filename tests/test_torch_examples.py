"""Port parity: the examples of motcpp_tpu_torch
(``motcpp_tpu_torch/examples/``) against the JAX package's ``examples/``.

Each JAX example runs in this process through ``runpy.run_path`` with
``sys.argv`` set to ``--cpu`` and the sizes of ``tests/test_examples.py``,
and the port's ``main([..., "--cpu"])`` runs on the same arguments; both
outputs are captured. The JAX example is shown one device
(``jax.devices()`` cut to its first), as when it runs alone: this test
process has the eight virtual CPU devices of ``tests/conftest.py``, and
the JAX examples print and spread their streams over the devices they
see, where the port's examples run on one device.

The printed lines are equal for basic_tracking, simple_tracking,
functional_core, multistream_tpu and stream_rebalance; moving_camera's
ids and verdict are equal and each estimated pan is within 0.05 px of
the JAX one (the port's sparse flow differs from XLA's by about 1e-2 px,
so a pan printed at one decimal may round the other way);
multistream_serving's lines are equal but for the times. The lines of
async_serving depend on the camera threads' timing, so only its markers
are compared. Every example that steps a tracker also runs with
``--lap auction_pallas`` (the plain auction on the CPU) against its run
with the exact solver: the two would print different lines only where
the auction's eps-optimal matching differs from the exact one on
near-equal costs, which none of these scenes has.
"""

import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu_torch.examples import (
    async_serving,
    basic_tracking,
    functional_core,
    moving_camera,
    multistream_serving,
    multistream_tpu,
    simple_tracking,
    stream_rebalance,
)

ROOT = Path(__file__).resolve().parent.parent
# the sizes of tests/test_examples.py (simple_tracking and
# multistream_serving take no sizes)
ARGS = {
    "basic_tracking": [],
    "simple_tracking": [],
    "functional_core": [],
    "multistream_tpu": ["--streams", "8", "--frames", "5"],
    "multistream_serving": [],
    "stream_rebalance": ["--frames", "10", "--move-at", "5"],
    "moving_camera": ["--streams", "2", "--ticks", "5"],
    "async_serving": ["--streams", "4", "--ticks", "6"],
}
PORT = {m.__name__.rsplit(".", 1)[1]: m for m in (
    async_serving, basic_tracking, functional_core, moving_camera,
    multistream_serving, multistream_tpu, simple_tracking, stream_rebalance)}
SAME_LINES = ("basic_tracking", "simple_tracking", "functional_core",
              "multistream_tpu", "stream_rebalance")
PAN_ATOL = 0.05


@pytest.fixture
def one_jax_device(monkeypatch):
    devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)


def run_jax(name, args, capsys, monkeypatch):
    """The JAX example ``name`` as ``python examples/<name>.py --cpu
    *args`` would run it, in this process; returns its stdout."""
    path = ROOT / "examples" / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--cpu", *args])
    monkeypatch.setattr(sys, "path", list(sys.path))  # the examples add to it
    capsys.readouterr()
    try:
        runpy.run_path(str(path), run_name="__main__")
    except SystemExit as exc:
        assert exc.code in (None, 0), exc.code
    return capsys.readouterr().out


def run_port(name, args, capsys):
    capsys.readouterr()
    assert PORT[name].main([*args, "--cpu"]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", SAME_LINES)
def test_example_prints_the_jax_lines(name, capsys, monkeypatch,
                                      one_jax_device):
    want = run_jax(name, ARGS[name], capsys, monkeypatch)
    got = run_port(name, ARGS[name], capsys)
    assert got.splitlines() == want.splitlines()
    if name == "stream_rebalance":
        assert "(5080 bytes of state)" in got
    if name == "multistream_tpu":
        assert "160 track emissions" in got


@pytest.mark.parametrize("name", ("basic_tracking", "simple_tracking",
                                  "functional_core", "multistream_tpu",
                                  "stream_rebalance", "moving_camera"))
def test_auction_kernel_route_prints_the_exact_solvers_lines(name, capsys):
    """On the CPU ``--lap auction_pallas`` runs the plain auction; these
    scenes' lines equal the exact solver's."""
    want = run_port(name, ARGS[name] + ["--lap", "jv"], capsys)
    got = run_port(name, ARGS[name] + ["--lap", "auction_pallas"], capsys)
    assert got.splitlines() == want.splitlines()


def test_unknown_tracker_fails_as_the_jax_example(capsys, monkeypatch):
    with pytest.raises(ValueError) as want:
        run_jax("basic_tracking", ["--tracker", "nope"], capsys, monkeypatch)
    with pytest.raises(ValueError) as got:
        run_port("basic_tracking", ["--tracker", "nope"], capsys)
    assert str(got.value) == str(want.value)
    assert "Unknown tracker" in str(got.value)
    assert "bytetrack" in str(got.value)


PANS = re.compile(r"estimated pans (\[[^\]]*\])")


def recorded_pans(monkeypatch, module, attr):
    """Wraps ``module.attr`` (a ``sof_jax_batch``) to record each call's
    x translations."""
    seen, sof = [], getattr(module, attr)

    def recording(prev, cur, *a, **k):
        warps, ok = sof(prev, cur, *a, **k)
        if isinstance(warps, torch.Tensor):
            seen.append(warps.cpu().numpy()[:, 0, 2])
        else:
            seen.append(np.asarray(warps)[:, 0, 2])
        return warps, ok

    monkeypatch.setattr(module, attr, recording)
    return seen


def test_moving_camera_tracks_as_the_jax_example(capsys, monkeypatch,
                                                 one_jax_device):
    import motcpp_tpu.motion
    import motcpp_tpu_torch.motion.cmc

    args = ARGS["moving_camera"]
    jax_pans = recorded_pans(monkeypatch, motcpp_tpu.motion, "sof_jax_batch")
    want = run_jax("moving_camera", args, capsys, monkeypatch).splitlines()
    port_pans = recorded_pans(monkeypatch, motcpp_tpu_torch.motion.cmc,
                              "sof_jax_batch")
    got = run_port("moving_camera", args, capsys).splitlines()
    assert len(jax_pans) == len(port_pans) == 4  # the ticks after the first
    np.testing.assert_allclose(np.stack(port_pans), np.stack(jax_pans),
                               rtol=0, atol=PAN_ATOL)
    assert [PANS.sub("", ln) for ln in got] == [PANS.sub("", ln)
                                                for ln in want]
    assert got[-2:] == want[-2:]
    assert got[-1] == "moving camera ok: STABLE"


CHUNK = re.compile(r"chunk (\d): (\S+) +[\d.]+ ms, (\d+) track emissions, "
                   r"[\d,]+ aggregate FPS")


def test_multistream_serving_prints_the_jax_lines_but_times(
        capsys, monkeypatch, one_jax_device):
    want = run_jax("multistream_serving", [], capsys, monkeypatch).splitlines()
    got = run_port("multistream_serving", [], capsys).splitlines()
    assert got[0] == want[0] == "Serving 64 streams on 1 device(s), backend=cpu"
    chunks = [[CHUNK.fullmatch(ln).groups() for ln in lines[1:]]
              for lines in (got, want)]
    assert chunks[0] == chunks[1] == [
        ("0", "compile+run", "15360"), ("1", "run", "15360"),
        ("2", "run", "15360")]


def test_async_serving_prints_the_jax_markers(capsys, monkeypatch,
                                              one_jax_device):
    """Which frames reach a tick depends on the camera threads' timing in
    both packages, so the counts differ from run to run: only the lines'
    forms and the markers are compared, and that rows were served."""
    args = ARGS["async_serving"]
    outs = [run_jax("async_serving", args, capsys, monkeypatch),
            run_port("async_serving", args, capsys)]
    for out in outs:
        lines = out.splitlines()
        assert lines[0] == "4 streams over 1 device(s)"
        assert lines[1].startswith("mux backend: ")
        ticks = [re.fullmatch(r"tick +(\d+): (\d)/4 streams present, (\d+) "
                              r"track rows", ln) for ln in lines[2:8]]
        assert [int(m.group(1)) for m in ticks] == list(range(6))
        served = re.match(r"served (\d+) track rows; stats: ", lines[8])
        assert int(served.group(1)) == sum(int(m.group(3)) for m in ticks)
        assert int(served.group(1)) > 0
        assert lines[9:] == ["async serving ok"]
