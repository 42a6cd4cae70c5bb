"""Port parity: the stream mux of motcpp_tpu_torch against the JAX
package's, on the same seeded schedules.

Each scenario runs on the port's native mux and its Python fallback and
on the JAX package's two; what they return (queue lengths, generations,
assembled batches byte for byte, counters) must be identical between the
packages and between the native and Python muxes of each. The port
builds the native library from ``native/motcpp_mux.cpp`` into
``motcpp_tpu_torch/_build/`` and writes nothing into ``native/``.
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu.serving import mux as jax_mux
from motcpp_tpu_torch import cuda_build
from motcpp_tpu_torch.serving import mux as port_mux

KINDS = ("python", "native")
NATIVE = port_mux.SOURCE.parent


def frame(rng, n, emb_dim=0):
    """n random boxes (n, 6), with (n, emb_dim) unit embeddings."""
    dets = np.zeros((n, 6), np.float32)
    cx = rng.uniform(100, 800, n)
    cy = rng.uniform(100, 500, n)
    w = rng.uniform(40, 100, n)
    h = rng.uniform(80, 200, n)
    dets[:, 0] = cx - w / 2
    dets[:, 1] = cy - h / 2
    dets[:, 2] = cx + w / 2
    dets[:, 3] = cy + h / 2
    dets[:, 4] = rng.uniform(0.5, 1.0, n)
    if emb_dim:
        e = rng.normal(0, 1, (n, emb_dim)).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True) + 1e-9
        return dets, e
    return dets


def make(pkg, kind, *args, **kw):
    """A mux of ``pkg`` (the port's or the JAX package's mux module)."""
    if kind == "native":
        assert pkg.native_available()
        return pkg.StreamMux(*args, **kw)
    return pkg.PyStreamMux(*args, **kw)


def run_both(kind, scenario, *args, **kw):
    """``scenario(mux)`` on the port's and the JAX package's mux of one
    kind; the two logs must be identical. Returns the port's log."""
    port = scenario(make(port_mux, kind, *args, **kw))
    ref = scenario(make(jax_mux, kind, *args, **kw))
    assert port == ref
    return port


def batch_bytes(out):
    """An assembled batch as bytes (buffers are reused: copy first)."""
    return tuple(None if a is None else np.array(a).tobytes() for a in out)


def test_native_mux_builds():
    assert port_mux.native_available()


def test_mux_native_matches_python():
    rng0 = np.random.default_rng(7)
    schedule = []  # shared random op schedule replayed on every mux
    for _ in range(200):
        op = rng0.choice(["submit", "assemble", "attach", "detach"],
                         p=[0.6, 0.2, 0.1, 0.1])
        schedule.append((op, rng0.integers(0, 10), rng0.integers(0, 6)))

    def scenario(mux):
        rng = np.random.default_rng(123)
        handles, log = {}, []
        for op, r, n in schedule:
            if op == "attach":
                try:
                    slot, gen = mux.attach()
                    handles[slot] = gen
                    log.append(("attach", slot, gen))
                except RuntimeError:
                    log.append(("attach", -1, -1))
            elif op == "detach" and handles:
                slot = sorted(handles)[int(r) % len(handles)]
                mux.detach(slot)
                del handles[slot]
                log.append(("detach", slot))
            elif op == "submit" and handles:
                slot = sorted(handles)[int(r) % len(handles)]
                log.append(("submit", slot,
                            mux.submit(slot, frame(rng, int(n)))))
            elif op == "assemble":
                dets, mask, _, warps, present, _ = mux.assemble()
                log.append(("assemble", dets.tobytes(), mask.tobytes(),
                            warps.tobytes(), present.tobytes()))
        log.append(("stats", tuple(sorted(mux.stats().items()))))
        return log

    logs = [run_both(kind, scenario, 4, 8, 0, 3) for kind in KINDS]
    assert logs[0] == logs[1]


@pytest.mark.parametrize("kind", KINDS)
def test_mux_drop_oldest(kind):
    def scenario(mux):
        slot, _ = mux.attach()
        f = [np.full((1, 6), i, np.float32) for i in range(3)]
        log = [mux.submit(slot, f[i]) for i in range(3)]
        assert log == [1, 2, 2]  # overflow: frame 0 evicted
        assert mux.stats()["dropped"] == 1
        dets, mask, _, _, present, _ = mux.assemble()
        assert present[0] and mask[0, 0] and not mask[0, 1]
        assert dets[0, 0, 0] == 1.0  # oldest surviving frame
        log.append(batch_bytes((dets, mask, present)))
        dets, _, _, _, _, _ = mux.assemble()
        assert dets[0, 0, 0] == 2.0
        _, _, _, _, present, _ = mux.assemble()
        assert not present[0]  # queue drained
        return log + [tuple(sorted(mux.stats().items()))]

    run_both(kind, scenario, 1, 4, 0, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_mux_truncates_and_embeds(kind):
    def scenario(mux):
        slot, _ = mux.attach()
        dets, embs = frame(np.random.default_rng(0), 5, emb_dim=4)  # 5 > N
        mux.submit(slot, dets, embs)
        out = mux.assemble()
        d, m, e, _, present, _ = out
        assert present[slot] and m[slot].sum() == 3
        np.testing.assert_array_equal(d[slot, :3], dets[:3])
        np.testing.assert_array_equal(e[slot, :3], embs[:3])
        assert (e[slot, 3:] == 0).all()
        with pytest.raises(ValueError, match="embs"):
            mux.submit(slot, dets, embs[:2])
        return [batch_bytes(out)]

    run_both(kind, scenario, 2, 3, 4, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_mux_slot_reuse_bumps_generation(kind):
    def scenario(mux):
        s0, g0 = mux.attach()
        mux.submit(s0, frame(np.random.default_rng(0), 2))
        mux.detach(s0)
        with pytest.raises(ValueError):
            mux.detach(s0)
        with pytest.raises(ValueError):
            mux.submit(s0, frame(np.random.default_rng(0), 1))
        s1, g1 = mux.attach()
        s2, g2 = mux.attach()
        assert {s1, s2} == {0, 1}
        with pytest.raises(RuntimeError, match="no free"):
            mux.attach()
        reused = s1 if s1 == s0 else s2
        gen = g1 if s1 == s0 else g2
        assert gen > g0
        # queued frames of the dead stream were discarded
        assert mux.pending(reused) == 0
        return [(s0, g0), (s1, g1), (s2, g2), mux.pending(reused)]

    run_both(kind, scenario, 2, 4)


@pytest.mark.parametrize("kind", KINDS)
def test_mux_warp_carried_per_frame(kind):
    ident = np.asarray([[1, 0, 0], [0, 1, 0]], np.float32)
    w1 = np.asarray([[1, 0, 5], [0, 1, -3]], np.float32)

    def scenario(mux):
        slot, _ = mux.attach()
        mux.submit(slot, frame(np.random.default_rng(0), 2), warp=w1)
        mux.submit(slot, frame(np.random.default_rng(1), 2))  # no warp
        out = mux.assemble()
        warps, present = out[3], out[4]
        assert present[slot]
        np.testing.assert_array_equal(warps[slot], w1)
        # absent slots (and warp-less frames) get the identity
        np.testing.assert_array_equal(warps[1 - slot], ident)
        log = [batch_bytes(out)]
        out = mux.assemble()
        np.testing.assert_array_equal(out[3][slot], ident)
        with pytest.raises(ValueError):
            mux.submit(slot, frame(np.random.default_rng(2), 1),
                       warp=np.zeros((3, 3), np.float32))
        return log + [batch_bytes(out)]

    run_both(kind, scenario, 2, 4, 0, 3)


def test_mux_crops_roundtrip():
    """Crops ride the queue as dets do: truncation at N, zero fill for
    short frames, native == Python byte for byte, port == JAX."""
    hw = (16, 8)

    def scenario(mux):
        rng = np.random.default_rng(5)
        s0, _ = mux.attach()
        for n in (2, 6, 0):  # 6 > N=4 truncates
            dets = frame(rng, n) if n else np.zeros((0, 6), np.float32)
            crops = rng.integers(0, 255, (n,) + hw + (3,)).astype(np.uint8)
            mux.submit(s0, dets, crops=crops)
        return [batch_bytes(mux.assemble()) for _ in range(3)]

    logs = [run_both(kind, scenario, 3, 4, 0, 3, crop_hw=hw)
            for kind in KINDS]
    assert logs[0] == logs[1]
    mux = port_mux.StreamMux(3, 4, 0, 3, crop_hw=hw)
    rng = np.random.default_rng(5)
    s0, _ = mux.attach()
    for n in (2, 6):
        mux.submit(s0, frame(rng, n), crops=rng.integers(
            0, 255, (n,) + hw + (3,)).astype(np.uint8))
    _, m, _, _, _, c = mux.assemble()
    assert m[0].sum() == 2
    assert (c[0, 2:] == 0).all() and (c[0, :2] != 0).any()
    _, m, _, _, _, c = mux.assemble()
    assert m[0].sum() == 4


@pytest.mark.parametrize("kind", KINDS)
def test_mux_crops_required_when_crop_enabled(kind):
    """A crop_hw mux rejects a detection frame without crops (zero-filled
    crops would feed identical black images to the ReID CNN) or with
    crops of the wrong shape; an empty frame needs none."""
    def scenario(mux):
        rng = np.random.default_rng(7)
        s0, _ = mux.attach()
        with pytest.raises(ValueError, match="crop"):
            mux.submit(s0, frame(rng, 2))
        with pytest.raises(ValueError, match="crops must be"):
            mux.submit(s0, frame(rng, 2),
                       crops=np.zeros((2, 8, 8, 3), np.uint8))
        return [mux.submit(s0, np.zeros((0, 6), np.float32))]

    run_both(kind, scenario, 3, 4, 0, 3, crop_hw=(16, 8))


def test_create_mux_fallback():
    assert isinstance(port_mux.create_mux(2, 4, prefer_native=False),
                      port_mux.PyStreamMux)
    assert isinstance(port_mux.create_mux(2, 4), port_mux.StreamMux)


def test_native_mux_abi_version_matches():
    """The loaded library reports the ABI version the ctypes signatures
    were written for, and a library that does not is refused."""
    lib = port_mux._load()
    assert lib.motmux_abi_version() == port_mux._ABI_VERSION == 2

    def version_one():
        return 1

    stale = type("StaleLib", (), {})()  # a library of ABI version 1
    stale.motmux_abi_version = version_one
    assert not port_mux._abi_ok(stale)
    assert not port_mux._abi_ok(type("UnversionedLib", (), {})())


# names the JAX package's own loaders write into native/ (test_serving.py
# and test_native_io.py may build them in another worker meanwhile)
JAX_ARTIFACTS = re.compile(r"libmotcpp_(io|mux)\.so(\.tmp\.\d+)?$")


def native_listing():
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in NATIVE.iterdir()
                  if not JAX_ARTIFACTS.match(p.name))


def test_build_writes_only_under_the_ports_build_dir(tmp_path, monkeypatch):
    """The library lands in motcpp_tpu_torch/_build/ under a name keyed on
    the source's hash; a fresh build (into a stand-in build directory)
    writes there only, through a temporary name, and leaves native/ as
    it was."""
    assert port_mux.build().parent == cuda_build.BUILD_DIR
    assert cuda_build.BUILD_DIR.parent.name == "motcpp_tpu_torch"

    before = native_listing()
    outputs = []
    run = subprocess.run

    def recording_run(cmd, *args, **kw):
        outputs.append(cmd[cmd.index("-o") + 1])
        return run(cmd, *args, **kw)

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(subprocess, "run", recording_run)
    path = port_mux.build()
    assert native_listing() == before
    assert outputs and all(o.startswith(str(tmp_path / "_build"))
                           for o in outputs)
    assert re.fullmatch(r"libmotcpp_mux_[0-9a-f]{16}\.so", path.name)
    assert sorted(p.name for p in path.parent.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])
    assert port_mux._abi_ok(ctypes.CDLL(str(path)))
