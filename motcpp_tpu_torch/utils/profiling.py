"""Tracing / profiling helpers.

Counterpart of ``motcpp_tpu/utils/profiling.py``. The reference has no
in-library tracing (SURVEY.md §5: FPS was measured externally). Here: a
per-frame step timer reporting the streams x FPS headline (a copy of the
JAX package's), :func:`trace`, a context over ``torch.profiler`` that
exports a Chrome trace (viewable in Perfetto or chrome://tracing), and
the timing and bounds that ``chip_smoke.py`` and the measurement tools
in ``motcpp_tpu_torch/scripts/`` share: :func:`call_ms` (device time by
CUDA events, or the host clock for a call on the CPU),
:func:`device_split` (the kernels' device time under
:func:`ranged` ranges), :func:`uncounted` (launches that do not count),
:func:`exact_float32` (TF32 off), :func:`crop_cosine`, the
H100's published rates
and :func:`bound_ms`, the least time of a piece of work at those rates
(:func:`osblock_bound_ms` for one OSBlock, :func:`auction_bound_ms` for
one auction solve).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device

# H100 SXM (NVIDIA data sheet): HBM rate, float32 rate outside the
# tensor cores and dense bf16 tensor-core rate, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# the modules of the CUDA kernels' wrappers, each counting its launches
KERNEL_WRAPPERS = ("motcpp_tpu_torch.ops.auction_cuda",
                   "motcpp_tpu_torch.appearance.osblock_cuda")


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


@contextlib.contextmanager
def exact_float32():
    """TF32 off for float32 matrix products and convolutions inside the
    block, PyTorch's settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def same_bits(a, b):
    """Whether two tensors are equal bit for bit, NaNs included (which
    ``torch.equal`` counts unequal) and signed zeros told apart."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave the CUDA kernels' launch counts
    (``LAUNCHES`` of the auction and OSBlock wrappers) as they were: the
    tools' warm-up calls and the calls that hold a result against its
    plain version are not runs of the path they measure."""
    import importlib

    mods = [importlib.import_module(m) for m in KERNEL_WRAPPERS]
    saved = [m.LAUNCHES for m in mods]
    try:
        yield
    finally:
        for m, n in zip(mods, saved):
            m.LAUNCHES = n


def call_ms(fn, reps, device="cuda"):
    """(ms, host ms) of fn() on ``device``: the mean time over reps calls
    after one warm-up, and the host's time to launch one call; the
    warm-up and the launch-timing call are :func:`uncounted`.

    On a CUDA device the time is the device's, by CUDA events: the timed
    calls are queued behind a kernel that sleeps for longer than the host
    takes to launch them, so the device runs them back to back, and a
    call whose launch takes the host longer than its kernels take the
    device is timed by the device, not by the host. (A call that
    synchronises with the host is timed with the host's gaps; so is a
    run of calls that outlasts the sleep, which is capped at 50 ms.) On
    the CPU it is the host clock's, as both."""
    cuda = torch.device(device).type == "cuda"
    with uncounted():
        fn()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) / reps * 1e3
        return ms, ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # at most 2e9 cycles a second (the H100's boost clock is 1.98 GHz)
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 0.05) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_s * 1e3


def ranged(fn, label):
    """fn, each call inside a ``torch.profiler.record_function`` range
    named ``label`` (what :func:`device_split` attributes kernels by)."""
    from torch.profiler import record_function

    def wrapper(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)

    return wrapper


def device_split(fn, labels):
    """torch.profiler over one call of ``fn()`` on the CUDA device, after
    one :func:`uncounted` warm-up call: {"wall_ms": the host's time under
    the profiler, "device_ms": the kernels' device time, "kernels": their
    count, "labels": {label: ms of the kernels that start inside one of
    the device spans of ``label``'s record_function ranges (see
    :func:`ranged`), None where it has no device span}}. A label's time
    includes the ranges nested in it. Raises where the profiler recorded
    no device time."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with uncounted():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # the profiler's raw events: building its event tree (prof.events())
    # takes seconds for a rollout's tens of thousands of kernels
    on_device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
    kernels = [(a, b) for name, a, b in on_device if name not in labels]
    device_us = sum(b - a for a, b in kernels) / 1e3
    if not device_us:
        raise RuntimeError("the profiler recorded no device time")
    split = {}
    for label in labels:
        spans = sorted((a, b) for name, a, b in on_device if name == label)
        starts = [a for a, _ in spans]
        ns = 0
        for a, b in kernels:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < spans[i][1]:
                ns += b - a
        split[label] = ns / 1e6 if spans else None
    return {"wall_ms": wall_s * 1e3, "device_ms": device_us / 1e3,
            "kernels": len(kernels), "labels": split}


def crop_cosine(a, b):
    """Per-crop cosine of two (B, ...) tensors, in float32: how the tools
    hold a kernel's output against its plain version's."""
    a, b = a.float().reshape(a.shape[0], -1), b.float().reshape(b.shape[0], -1)
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)


def bound_ms(ops, nbytes, ops_per_s, bytes_per_s=HBM_BYTES_PER_S):
    """(ms, "bytes" or "operations"): the least time for work that moves
    ``nbytes`` and does ``ops`` operations, the larger of the two times
    at the given rates, and which of them bounds it."""
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def osblock_cost(w, B, H, W, dtype):
    """(operations, bytes) of one OSBlock (``appearance/osblock.py``'s
    BlockWeights ``w``) over B crops of H x W: its input read once and
    its output written once (weights too), and two operations a
    multiply-add of its convolutions and gate."""
    elem = 2 if dtype == torch.bfloat16 else 4
    nbytes = (B * H * W * (w.cin + w.cout) * elem
              + w.mats.numel() * elem + w.biases.numel() * 4)
    macs_px = (w.cin * w.mid + 10 * (w.mid * w.mid + 9 * w.mid)
               + 4 * w.mid + w.mid * w.cout
               + (w.cin * w.cout if w.has_ds else 0))
    ops = 2 * B * (H * W * macs_px + 4 * 2 * w.mid * w.hidden)
    return ops, nbytes


def osblock_bound_ms(w, B, H, W, dtype):
    """Least time for one block over B crops: :func:`osblock_cost`'s
    bytes at the HBM rate or its operations at the peak rate of the type
    (bf16 tensor cores, or float32 CUDA cores), whichever is longer."""
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    return bound_ms(*osblock_cost(w, B, H, W, dtype), peak)


def auction_bound_ms(cost, rm, cm, th):
    """Least time for one auction solve: what the function needs read
    once and written once at the HBM rate, or one pass of (v = b - p,
    max) over every valid pair at the float32 rate, whichever is longer.
    The bytes are the masks, the thresholds, the outputs, and of the
    costs only the 32-byte sectors that hold a valid pair (no other cost
    changes the result). Returns (ms, "bytes" or "operations")."""
    P, k, n = cost.shape
    valid = (rm[:, :, None] & cm[:, None, :]).reshape(-1)
    pad = -valid.numel() % 8
    sectors = int(torch.nn.functional.pad(valid, (0, pad)).view(-1, 8)
                  .any(1).sum())
    nbytes = (sectors * 32 + rm.numel() + cm.numel() + th.numel() * 4
              + P * (k + n) * 4)
    return bound_ms(2 * int(valid.sum()), nbytes, FP32_OPS_PER_S)


def full_tile_bound_ms(cost, rm, cm, th):
    """The bytes bound of one auction solve with every cost tile read
    whole, as it was stated before the kernel skipped what the function
    does not need."""
    P, k, n = cost.shape
    nbytes = (cost.numel() * 4 + rm.numel() + cm.numel() + th.numel() * 4
              + P * (k + n) * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3
