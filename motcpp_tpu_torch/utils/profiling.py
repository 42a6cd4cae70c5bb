"""Tracing / profiling helpers.

Counterpart of ``motcpp_tpu/utils/profiling.py``. The reference has no
in-library tracing (SURVEY.md §5: FPS was measured externally). Here: a
per-frame step timer reporting the streams x FPS headline (a copy of the
JAX package's), and :func:`trace`, a context over ``torch.profiler`` that
exports a Chrome trace (viewable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np

from motcpp_tpu_torch.device import resolve_device


class FrameTimer:
    """Accumulates per-frame wall times; reports throughput.

    Example:
        timer = FrameTimer(n_streams=256)
        for frame in frames:
            with timer:
                out = tracker.update(...)
        print(timer.report())
    """

    def __init__(self, n_streams: int = 1):
        self.n_streams = n_streams
        self.times: list[float] = []
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return self.n_streams * len(self.times) / sum(self.times)

    def report(self) -> dict:
        t = np.asarray(self.times)
        if t.size == 0:
            return {}
        return dict(
            frames=len(t),
            streams=self.n_streams,
            mean_ms=float(t.mean() * 1e3),
            p50_ms=float(np.percentile(t, 50) * 1e3),
            p95_ms=float(np.percentile(t, 95) * 1e3),
            aggregate_fps=float(self.fps),
            streams_at_30fps=float(self.fps / 30.0),
        )


@contextlib.contextmanager
def trace(logdir: str | None = None, device="cuda"):
    """Profile the block with ``torch.profiler`` and export a Chrome trace
    into ``logdir`` (default: ``motcpp_trace`` under the temporary
    directory) as ``<host>_<pid>.<time>.pt.trace.json``; yields
    ``logdir``. On a CUDA ``device`` the trace records the card's
    kernels and copies beside the host's operators; ``"cpu"`` records
    the host only. Raises where the device is missing, and where the
    profiler fails to start: unlike the JAX package's ``trace``, a
    profile that cannot see the device is an error, not a no-op."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    dev = resolve_device(device)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "motcpp_trace")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
