"""Stream multiplexer: async per-stream frames -> fixed-shape batches.

Counterpart of ``motcpp_tpu/serving/mux.py``, with the same contract:
ctypes bindings for the native runtime (``native/motcpp_mux.cpp``):
per-slot bounded frame queues with drop-oldest overflow, assembled into
the (S, N, 6) detection batches the stream-batched tracker step
consumes. :class:`PyStreamMux` is a pure-Python fallback so the serving
layer works without a toolchain; :func:`create_mux` picks one.

The native source is read where it is and never written: the library is
built with ``g++`` into ``motcpp_tpu_torch/_build/`` under a name keyed
on a hash of the source and flags (``cuda_build.build``), not next to
the source as the JAX package builds it. Nothing is built at import.

The reference library has no ingest runtime: its scaling advice is one
tracker instance per thread (reference: docs/guides/architecture.md:
246-258). Here threads feed slots and one device steps every slot at
once.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from collections import deque
from pathlib import Path

import numpy as np

from motcpp_tpu_torch import cuda_build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "motcpp_mux.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False

DET_COLS = 6

# must match motmux_abi_version() in native/motcpp_mux.cpp: a library
# built from another version of the source would be called through
# mismatched ctypes signatures and silently drop arguments
_ABI_VERSION = 2


def build() -> Path:
    """Compile the native mux unless this source and these flags have
    been built; returns the library's path (under
    ``motcpp_tpu_torch/_build/``). Raises when ``g++`` fails."""
    return cuda_build.build(SOURCE, FLAGS, "motcpp_mux", compiler="g++")


def _abi_ok(lib) -> bool:
    try:
        fn = lib.motmux_abi_version
    except AttributeError:  # pre-versioning build
        return False
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return fn() == _ABI_VERSION


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        if not _abi_ok(lib):
            return None
        lib.motmux_create.restype = ctypes.c_void_p
        lib.motmux_create.argtypes = [ctypes.c_int] * 5
        lib.motmux_destroy.argtypes = [ctypes.c_void_p]
        lib.motmux_attach.restype = ctypes.c_int
        lib.motmux_attach.argtypes = [ctypes.c_void_p]
        lib.motmux_detach.restype = ctypes.c_int
        lib.motmux_detach.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.motmux_generation.restype = ctypes.c_long
        lib.motmux_generation.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.motmux_submit.restype = ctypes.c_int
        lib.motmux_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.motmux_assemble.restype = ctypes.c_int
        lib.motmux_assemble.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.motmux_pending.restype = ctypes.c_int
        lib.motmux_pending.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.motmux_stats.restype = ctypes.c_long
        lib.motmux_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _bptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


class StreamMux:
    """Native-backed multiplexer; :func:`create_mux` falls back to
    :class:`PyStreamMux` when the library cannot be built.

    Args:
        n_streams: S stream slots.
        max_dets: N detection slots per frame (extra rows truncate).
        emb_dim: per-detection embedding width, 0 = no embeddings.
        queue_depth: per-slot frame queue; overflow drops the OLDEST
            queued frame (live streams prefer freshness).
        crop_hw: (Hc, Wc) of the uint8 BGR detection crops each frame
            carries (live ReID), or None.
    """

    def __init__(self, n_streams: int, max_dets: int, emb_dim: int = 0,
                 queue_depth: int = 4, crop_hw: tuple | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native mux unavailable")
        self._lib = lib
        self.n_streams = int(n_streams)
        self.max_dets = int(max_dets)
        self.emb_dim = int(emb_dim)
        self.queue_depth = int(queue_depth)
        self.crop_hw = tuple(int(x) for x in crop_hw) if crop_hw else None
        crop_bytes = (
            self.crop_hw[0] * self.crop_hw[1] * 3 if self.crop_hw else 0
        )
        self._h = lib.motmux_create(
            self.n_streams, self.max_dets, self.emb_dim, self.queue_depth,
            crop_bytes,
        )
        if not self._h:
            raise RuntimeError("motmux_create failed")
        S, N, D = self.n_streams, self.max_dets, self.emb_dim
        # reusable batch buffers: assemble() overwrites them in place
        self._dets = np.zeros((S, N, DET_COLS), np.float32)
        self._mask = np.zeros((S, N), np.uint8)
        self._embs = np.zeros((S, N, max(D, 1)), np.float32)
        self._warps = np.zeros((S, 2, 3), np.float32)
        self._present = np.zeros((S,), np.uint8)
        self._crops = (
            np.zeros((S, N) + self.crop_hw + (3,), np.uint8)
            if self.crop_hw else None
        )

    def close(self):
        if getattr(self, "_h", None):
            self._lib.motmux_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def attach(self):
        """Claim a slot; returns (slot, generation). Raises when full."""
        s = self._lib.motmux_attach(self._h)
        if s < 0:
            raise RuntimeError("no free stream slots")
        return s, int(self._lib.motmux_generation(self._h, s))

    def detach(self, slot: int) -> None:
        if self._lib.motmux_detach(self._h, int(slot)) != 0:
            raise ValueError(f"slot {slot} is not attached")

    def submit(self, slot: int, dets, embs=None, warp=None,
               crops=None) -> int:
        """Queue one frame; returns the queue length after the submit.
        warp: optional (2, 3) camera warp for this frame (identity when
        omitted). crops: (n, Hc, Wc, 3) uint8 BGR detection crops,
        required when the mux was built with crop_hw."""
        dets = np.ascontiguousarray(dets, np.float32).reshape(-1, DET_COLS)
        n = dets.shape[0]
        if n == 0:  # keep a valid pointer for the native call
            dets = np.zeros((1, DET_COLS), np.float32)
        eptr = None
        if self.emb_dim > 0 and embs is not None:
            embs = np.ascontiguousarray(embs, np.float32)
            if embs.shape != (n, self.emb_dim):
                raise ValueError(
                    f"embs must be ({n}, {self.emb_dim}), got {embs.shape}"
                )
            eptr = _fptr(embs)
        wptr = None
        if warp is not None:
            warp = np.ascontiguousarray(warp, np.float32)
            if warp.shape != (2, 3):
                raise ValueError(f"warp must be (2, 3), got {warp.shape}")
            wptr = _fptr(warp)
        cptr = None
        if self.crop_hw is not None:
            if crops is None and n > 0:
                # zero-filled crops would silently feed identical black
                # images to the ReID CNN: fail loudly instead
                raise ValueError(
                    "mux was built with crop_hw="
                    f"{self.crop_hw}: submit() requires crops of shape "
                    f"({n}, {self.crop_hw[0]}, {self.crop_hw[1]}, 3)"
                )
            if crops is not None:
                crops = np.ascontiguousarray(crops, np.uint8)
                want = (n,) + self.crop_hw + (3,)
                if crops.shape != want:
                    raise ValueError(
                        f"crops must be {want}, got {crops.shape}")
                cptr = _bptr(crops)
        r = self._lib.motmux_submit(
            self._h, int(slot), _fptr(dets), n, eptr, wptr, cptr
        )
        if r < 0:
            raise ValueError(f"slot {slot} is not attached")
        return r

    def assemble(self):
        """Pop one frame per live slot into the reusable batch buffers.

        Returns (dets (S,N,6) f32, mask (S,N) bool, embs (S,N,D) f32 or
        None, warps (S,2,3) f32, present (S,) bool, crops
        (S,N,Hc,Wc,3) u8 or None). Absent slots get the identity warp.
        dets, embs, warps and crops are the mux's own buffers, which the
        next assemble OVERWRITES: consumers must copy them (a device
        transfer counts only once it has completed); mask and present
        are fresh arrays.
        """
        r = self._lib.motmux_assemble(
            self._h, _fptr(self._dets), _bptr(self._mask),
            _fptr(self._embs), _fptr(self._warps), _bptr(self._present),
            _bptr(self._crops) if self._crops is not None else None,
        )
        if r < 0:
            raise RuntimeError("motmux_assemble failed")
        embs = self._embs if self.emb_dim > 0 else None
        return (
            self._dets, self._mask.astype(bool), embs, self._warps,
            self._present.astype(bool), self._crops,
        )

    def pending(self, slot: int) -> int:
        return int(self._lib.motmux_pending(self._h, int(slot)))

    def stats(self) -> dict:
        return {
            "submitted": int(self._lib.motmux_stats(self._h, 0)),
            "dropped": int(self._lib.motmux_stats(self._h, 1)),
            "assembled": int(self._lib.motmux_stats(self._h, 2)),
            "attached": int(self._lib.motmux_stats(self._h, 3)),
        }


class PyStreamMux:
    """Pure-Python fallback with the exact same contract as StreamMux."""

    def __init__(self, n_streams: int, max_dets: int, emb_dim: int = 0,
                 queue_depth: int = 4, crop_hw: tuple | None = None):
        self.n_streams = int(n_streams)
        self.max_dets = int(max_dets)
        self.emb_dim = int(emb_dim)
        self.queue_depth = int(queue_depth)
        self.crop_hw = tuple(int(x) for x in crop_hw) if crop_hw else None
        self._lock = threading.Lock()
        self._attached = [False] * self.n_streams
        self._gen = [0] * self.n_streams
        self._q = [deque() for _ in range(self.n_streams)]
        self._next_probe = 0
        self._submitted = 0
        self._dropped = 0
        self._assembled = 0
        S, N, D = self.n_streams, self.max_dets, self.emb_dim
        self._dets = np.zeros((S, N, DET_COLS), np.float32)
        self._mask = np.zeros((S, N), bool)
        self._embs = np.zeros((S, N, max(D, 1)), np.float32)
        self._warps = np.zeros((S, 2, 3), np.float32)
        self._present = np.zeros((S,), bool)
        self._crops = (
            np.zeros((S, N) + self.crop_hw + (3,), np.uint8)
            if self.crop_hw else None
        )

    def close(self):
        pass

    def attach(self):
        with self._lock:
            for k in range(self.n_streams):
                s = (self._next_probe + k) % self.n_streams
                if not self._attached[s]:
                    self._attached[s] = True
                    self._gen[s] += 1
                    self._q[s].clear()
                    self._next_probe = s + 1
                    return s, self._gen[s]
        raise RuntimeError("no free stream slots")

    def detach(self, slot: int) -> None:
        with self._lock:
            if not (0 <= slot < self.n_streams) or not self._attached[slot]:
                raise ValueError(f"slot {slot} is not attached")
            self._attached[slot] = False
            self._q[slot].clear()

    def submit(self, slot: int, dets, embs=None, warp=None,
               crops=None) -> int:
        dets = np.ascontiguousarray(dets, np.float32).reshape(-1, DET_COLS)
        n = min(dets.shape[0], self.max_dets)
        e = None
        if self.emb_dim > 0 and embs is not None:
            embs = np.ascontiguousarray(embs, np.float32)
            if embs.shape != (dets.shape[0], self.emb_dim):
                raise ValueError(
                    f"embs must be ({dets.shape[0]}, {self.emb_dim}), "
                    f"got {embs.shape}"
                )
            e = embs[:n].copy()
        if warp is not None:
            warp = np.ascontiguousarray(warp, np.float32)
            if warp.shape != (2, 3):
                raise ValueError(f"warp must be (2, 3), got {warp.shape}")
            warp = warp.copy()
        c = None
        if self.crop_hw is not None:
            if crops is None and dets.shape[0] > 0:
                raise ValueError(
                    "mux was built with crop_hw="
                    f"{self.crop_hw}: submit() requires crops of shape "
                    f"({dets.shape[0]}, {self.crop_hw[0]}, "
                    f"{self.crop_hw[1]}, 3)"
                )
            if crops is not None:
                crops = np.ascontiguousarray(crops, np.uint8)
                want = (dets.shape[0],) + self.crop_hw + (3,)
                if crops.shape != want:
                    raise ValueError(
                        f"crops must be {want}, got {crops.shape}")
                c = crops[:n].copy()
        with self._lock:
            if not (0 <= slot < self.n_streams) or not self._attached[slot]:
                raise ValueError(f"slot {slot} is not attached")
            q = self._q[slot]
            if len(q) == self.queue_depth:
                q.popleft()
                self._dropped += 1
            q.append((dets[:n].copy(), e, warp, c))
            self._submitted += 1
            return len(q)

    def assemble(self):
        """As :meth:`StreamMux.assemble`, the same buffers overwritten."""
        S, D = self.n_streams, self.emb_dim
        self._mask[:] = False
        self._present[:] = False
        ident = np.asarray([[1, 0, 0], [0, 1, 0]], np.float32)
        with self._lock:
            for s in range(S):
                self._warps[s] = ident
                if not self._attached[s] or not self._q[s]:
                    continue
                d, e, w, c = self._q[s].popleft()
                n = d.shape[0]
                self._dets[s, :n] = d
                self._dets[s, n:] = 0.0
                if D > 0:
                    self._embs[s, :n] = 0.0 if e is None else e
                    self._embs[s, n:] = 0.0
                if self._crops is not None:
                    self._crops[s, :n] = 0 if c is None else c
                    self._crops[s, n:] = 0
                if w is not None:
                    self._warps[s] = w
                self._mask[s, :n] = True
                self._present[s] = True
            self._assembled += 1
        embs = self._embs if D > 0 else None
        return (self._dets, self._mask.copy(), embs, self._warps,
                self._present.copy(), self._crops)

    def pending(self, slot: int) -> int:
        with self._lock:
            if not (0 <= slot < self.n_streams) or not self._attached[slot]:
                return -1
            return len(self._q[slot])

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self._submitted,
                "dropped": self._dropped,
                "assembled": self._assembled,
                "attached": sum(self._attached),
            }


def create_mux(n_streams: int, max_dets: int, emb_dim: int = 0,
               queue_depth: int = 4, prefer_native: bool = True,
               crop_hw: tuple | None = None):
    """Native mux when the toolchain allows, PyStreamMux otherwise."""
    if prefer_native and native_available():
        return StreamMux(n_streams, max_dets, emb_dim, queue_depth, crop_hw)
    return PyStreamMux(n_streams, max_dets, emb_dim, queue_depth, crop_hw)
