#!/usr/bin/env python3
"""On-card smoke run of motcpp_tpu_torch: builds the CUDA kernels from
the sources in this checkout, holds each against its plain PyTorch
version, drives the ByteTrack multi-stream path at the bench's flagship
shape and checks what it emits.

    python3 chip_smoke.py

Needs one CUDA device (written for an H100, sm_90a) and nvcc. Phases:

  1. build the auction kernel; print the card's name and power limit;
  2. the kernel against the plain auction at (K, N) = (64, 32),
     (128, 64), (128, 128) and (256, 128): identical row2col/col2row;
  3. the main path: MultiStreamRunner over ByteTrack with the kernel
     (lap_impl="auction_pallas"), S=4096 streams, K=64 slots, N=32 dets,
     16 objects, T=60 frames; one warm-up and 5 timed run()s, each
     launching the kernel exactly 2*T times; then the kernel timed on
     the inputs the main path gave it, beside its plain version (the
     kernels line gives both launches of one frame summed), and a
     torch.profiler trace of 10 frames;
  4. the same rollout on 256 streams through the kernel and through the
     plain auction: identical masks, ids and boxes.

Any failed check exits nonzero before the result is printed. The last
line is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their times and bounds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# the run and its result line describe one card: unless the caller chose
# the visible devices, use the first
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM (NVIDIA data sheet): HBM rate and float32 rate outside the
# tensor cores, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

S, K, N, N_OBJ, T, REPEATS = 4096, 64, 32, 16, 60, 5
CHECK_SHAPES = [(64, 32, 4096), (128, 64, 1024), (128, 128, 1024),
                (256, 128, 256)]
EQUAL_STREAMS = 256


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def auction_inputs(rng, P, k, n):
    """Seeded problems of every class the kernel must agree on: random
    masks and thresholds, +inf and negative costs, empty problems, and a
    quarter of dense uniform near-tie problems at thresh 0.9."""
    cost = rng.random((P, k, n)).astype(np.float32)
    cost[rng.random((P, k, n)) < 0.05] = np.inf
    cost[rng.random(P) < 0.1] -= 1.0
    rm = rng.random((P, k)) < 0.7
    cm = rng.random((P, n)) < 0.7
    rm[rng.random(P) < 0.02] = False
    th = rng.choice(np.float32([0.5, 0.7, 0.8, 0.9]), P)
    q = P // 4
    cost[:q] = rng.uniform(0, 1, (q, k, n))
    rm[:q] = rng.random((q, k)) < 0.5
    cm[:q] = rng.random((q, n)) < 0.6
    th[:q] = 0.9
    return [torch.from_numpy(a).cuda() for a in (cost, rm, cm, th)]


def auction_bound_ms(cost, rm, cm, th):
    """Least time for one solve: each input read once and each output
    written once at the HBM rate, or one pass of (v = b - p, max) over
    every valid pair at the float32 rate, whichever is longer."""
    P, k, n = cost.shape
    nbytes = (cost.numel() * 4 + rm.numel() + cm.numel() + th.numel() * 4
              + P * (k + n) * 4)
    valid_pairs = int((rm[:, :, None] & cm[:, None, :]).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * valid_pairs / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def matching_err(got, want):
    """Largest absolute difference of row2col and col2row (0 if equal)."""
    return max(int((g - w).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def profile_frames(runner, dets, masks, frames=10):
    """torch.profiler over `frames` frames of the main path, mid-sequence:
    device busy share of the wall time, the auction kernel's share of
    the device time, and the kernels that take the most device time.
    The profiler's own host cost inflates the wall time it sees."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.reset()
    half = dets.shape[0] // 2
    runner.run(dets[:half], masks[:half])
    sl = slice(half, half + frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(dets[sl], masks[sl])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    launched = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in launched)
    if not device_us:
        return "profiler recorded no device time: busy share not measured"
    auction_us = sum(e.self_device_time_total for e in launched
                     if "auction" in e.key)
    # device time attributed to the PyTorch operator that launched it
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    top = "; ".join(
        f"{e.key} {e.self_device_time_total / frames / 1e3:.4f} ms "
        f"x{e.count // frames}" for e in ops[:6])
    return (f"{frames} frames: wall {wall_us / frames / 1e3:.3f} ms/frame "
            f"under the profiler, device busy {device_us / frames / 1e3:.3f} "
            f"ms/frame ({100 * device_us / wall_us:.1f}% of wall), auction "
            f"kernel {auction_us / frames / 1e3:.4f} ms/frame "
            f"({100 * auction_us / device_us:.1f}% of device time), "
            f"{sum(e.count for e in launched) // frames} kernels/frame; "
            f"top operators by device time per frame: {top}")


def run_smoke():
    from motcpp_tpu_torch.data import synth_stream_dets
    from motcpp_tpu_torch.models.bytetrack import ByteTrackConfig, make_bytetrack
    from motcpp_tpu_torch.ops import auction, auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = auction_cuda.build()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 build: {lib.name} in {build_s:.2f} s; card: {smi}")

    # ---- 2. kernel against its plain version -----------------------------
    rng = np.random.default_rng(0)
    max_err = 0
    for k, n, P in CHECK_SHAPES:
        args = auction_inputs(rng, P, k, n)
        got = auction_cuda.solve(*args)
        torch.cuda.synchronize()
        err = matching_err(got, auction.solve_lap_auction(*args))
        max_err = max(max_err, err)
        check(err == 0, f"kernel and plain auction disagree at K={k}, N={n}")
        matched = int((got[0] >= 0).sum())
        k_ms = cuda_ms(lambda: auction_cuda.solve(*args), 10)
        p_ms = cuda_ms(lambda: auction.solve_lap_auction(*args), 1)
        print(f"phase 2 kernel=plain K={k} N={n} P={P}: identical "
              f"({matched} matches); kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms")

    # ---- 3. main path ----------------------------------------------------
    cfg = ByteTrackConfig(max_tracks=K, max_dets=N, lap_impl="auction_pallas")
    init, step = make_bytetrack(cfg, device="cuda")
    dets_np, masks_np = synth_stream_dets(np.random.default_rng(0), T, S, N,
                                          n_obj=N_OBJ)
    dets = torch.from_numpy(dets_np).cuda()
    masks = torch.from_numpy(masks_np).cuda()
    runner = MultiStreamRunner(init, step, S, device="cuda")

    auction_cuda.LAUNCHES = 0
    times, emitted = [], 0
    for rep in range(1 + REPEATS):
        runner.reset()
        before = auction_cuda.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, out_masks = runner.run(dets, masks)
        torch.cuda.synchronize()
        if rep:
            times.append(time.perf_counter() - t0)
        check(auction_cuda.LAUNCHES - before == 2 * T,
              f"run {rep}: {auction_cuda.LAUNCHES - before} kernel launches, "
              f"want {2 * T}")
        emitted = int(out_masks.sum())
    launches = auction_cuda.LAUNCHES
    check(launches > 0, "the main path never launched the kernel")
    check(outs.shape == (T, S, K, 8) and out_masks.shape == (T, S, K),
          f"output shapes {tuple(outs.shape)}, {tuple(out_masks.shape)}")
    check(emitted > 0, "the main path emitted no tracks")
    check(bool(torch.isfinite(outs[out_masks]).all()),
          "non-finite emitted boxes")
    run_s = float(np.median(times))
    fps = S * T / run_s
    print(f"phase 3 main path S={S} K={K} N={N} T={T}: "
          f"{run_s * 1e3 / T:.3f} ms per frame-batch (median of {REPEATS}, "
          f"runs {[round(t * 1e3, 1) for t in times]} ms), {fps:.0f} "
          f"frames/s, {fps / 30:.0f} streams at 30 FPS, {emitted} emissions "
          f"in the last run, {launches} kernel launches "
          f"({launches // (1 + REPEATS)} per run)")

    # the kernel on the inputs the main path gives it, mid-sequence
    runner.reset()
    runner.run(dets[: T // 2], masks[: T // 2])
    captured = []
    solve = auction_cuda.solve

    def recording_solve(*args):
        captured.append([t.clone() for t in args])
        return solve(*args)

    auction_cuda.solve = recording_solve
    try:
        runner.run(dets[T // 2: T // 2 + 1], masks[T // 2: T // 2 + 1])
    finally:
        auction_cuda.solve = solve
    check(len(captured) == 2, f"captured {len(captured)} solves, want 2")
    k_ms = p_ms = b_ms = 0.0
    bound_by = set()
    for name, args in zip(("stage 1", "stages 2+3"), captured):
        err = matching_err(solve(*args), auction.solve_lap_auction(*args))
        max_err = max(max_err, err)
        check(err == 0,
              f"kernel and plain auction disagree on the main path's {name}")
        ks = cuda_ms(lambda: solve(*args), 20)
        ps = cuda_ms(lambda: auction.solve_lap_auction(*args), 3)
        bs, by = auction_bound_ms(*args)
        k_ms, p_ms, b_ms = k_ms + ks, p_ms + ps, b_ms + bs
        bound_by.add(by)
        print(f"phase 3 kernel on the main path's {name} "
              f"{tuple(args[0].shape)}: kernel {ks:.4f} ms, plain {ps:.3f} "
              f"ms, bound {bs:.4f} ms ({by}), max abs err {err}")

    print(f"phase 3 profile: {profile_frames(runner, dets, masks)}")

    # ---- 4. kernel path against the plain path ---------------------------
    d, m = dets[:, :EQUAL_STREAMS], masks[:, :EQUAL_STREAMS]
    emitted_by = {}
    results = {}
    for lap in ("auction_pallas", "auction"):
        i_fn, s_fn = make_bytetrack(
            ByteTrackConfig(max_tracks=K, max_dets=N, lap_impl=lap),
            device="cuda")
        results[lap] = MultiStreamRunner(i_fn, s_fn, EQUAL_STREAMS,
                                         device="cuda").run(d, m)
        emitted_by[lap] = int(results[lap][1].sum())
    (ko, km), (po, pm) = results["auction_pallas"], results["auction"]
    check(torch.equal(km, pm), "kernel and plain paths emit different masks")
    check(torch.equal(ko[km], po[pm]),
          "kernel and plain paths emit different ids or boxes")
    print(f"phase 4 kernel path = plain path on {EQUAL_STREAMS} streams: "
          f"identical ({emitted_by['auction_pallas']} emissions)")

    kernels = [{
        "name": "auction",
        "route": "cuda",
        "source": "motcpp_tpu_torch/csrc/auction.cu",
        "replaces": "motcpp_tpu/ops/auction_pallas.py:66",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": None,
    }]
    return kernels, smi


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} CUDA devices visible;"
              " set CUDA_VISIBLE_DEVICES to one", file=sys.stderr)
        return 1
    try:
        kernels, smi = run_smoke()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),  # 1, checked above
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
