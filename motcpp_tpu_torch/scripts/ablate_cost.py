#!/usr/bin/env python3
"""Attribute a tracker's per-frame cost to stages by ablation.

Counterpart of the JAX package's ``scripts/ablate_cost.py``. It times the
scoreboard's rollout (``scripts/tracker_fns.py`` through
``parallel/streams.py::MultiStreamRunner`` over
``data/synthetic.py::synth_stream_dets``), then the same rollout with one
hot stage at a time stubbed out (set on the tracker's model module with
``setattr`` and restored in ``finally``) by a cheap substitute of the
same shapes, and reports each stage's share: the baseline's ms per
frame-batch less the ablated one's. The stubs are not valid trackers;
only the timing matters.

  lap         ``solve_lap_masked`` -> an argmin per row and column
  iou         ``iou_batch`` -> one broadcast subtraction
  asso        ``get_asso_fn`` -> returns the iou stub
  kf_predict  ``xysr_predict`` -> the state as it is
  kf_update   ``xysr_update`` -> the state plus 1e-12 of the measurement
  ring        ``_k_previous_obs`` -> the ring's first slot
  apply       ``_observe`` (OC-SORT's observation update; the JAX
              package's ``_apply_track_update``, which is a closure there
              and so skipped) -> the state with a tiny dependency on
              the matches

The tracker is rebuilt after each stub is set, so a stage that a step
binds when it is built (``get_asso_fn``) is stubbed too. Each stub
counts its calls, and a run in which an ablated stub was never called
fails: the stub did nothing. The card is synchronised around every timed
rollout, and each row gives the spread of its timed rollouts beside
their median.

Where the rollout is host-bound (the card idle between the step's
launches), an ablation's delta is the host's time and moves between
runs by as much as the shares. So on the card the script also splits one
rollout of the unstubbed tracker by device time: each stage of the table
that the tracker's module has runs inside a ``torch.profiler`` range
named after it (``get_asso_fn``'s result for ``asso``), and
``utils/profiling.py::device_split`` sums the kernels that start inside
each stage's ranges: the stage's device ms per frame-batch and its share
of the rollout's device time (a stage's time includes the stages it
calls: ``apply`` holds ``kf_update`` and ``ring``), beside the device's
busy share of the rollout's wall time. On the CPU that split is not
measured.

Usage:
  python -m motcpp_tpu_torch.scripts.ablate_cost --tracker boosttrack [--streams 2048] [--ablate lap iou ...]
  python -m motcpp_tpu_torch.scripts.ablate_cost --cpu --tracker ocsort --streams 4 --frames 4 --ablate lap asso ring apply

It runs on the CUDA device with ``--lap auction_pallas`` (the auction
CUDA kernel) and raises without one unless given ``--cpu`` (the plain
auction; host times, not the card's).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import time

import numpy as np
import torch

from motcpp_tpu_torch.scripts.tracker_fns import TRACKERS, build_tracker_fns
from motcpp_tpu_torch.utils.profiling import device_split, ranged, uncounted


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--tracker", default="boosttrack", choices=TRACKERS)
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--objects", type=int, default=16)
    ap.add_argument("--max-tracks", type=int, default=64)
    ap.add_argument("--max-dets", type=int, default=32)
    ap.add_argument("--lap", default="auction_pallas",
                    choices=["jv", "auction", "auction_pallas"])
    ap.add_argument("--emb-dim", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--ablate", nargs="*", default=["lap", "iou"])
    return ap


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rollout(tracker, args, dev):
    """run(): the scoreboard's rollout of ``tracker`` (built now, through
    the model module's attributes as they stand) from a reset runner,
    returning the count of emissions."""
    from motcpp_tpu_torch.data import synth_stream_dets
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    init_fn, step_fn = build_tracker_fns(
        tracker, args.max_tracks, args.max_dets, args.lap, args.emb_dim,
        device=dev)
    S, T, N = args.streams, args.frames, args.max_dets
    rng = np.random.default_rng(0)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=args.objects)
    kw = {}
    if args.emb_dim > 0:
        e = rng.normal(0, 1, (T, S, N, args.emb_dim)).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True) + 1e-9
        kw["embs"] = torch.from_numpy(e).to(dev)
    runner = MultiStreamRunner(init_fn, step_fn, S, device=dev,
                               with_embs=args.emb_dim > 0)
    dets_t, masks_t = torch.from_numpy(dets).to(dev), torch.from_numpy(
        masks).to(dev)

    def run():
        runner.reset()
        return int(runner.run(dets_t, masks_t, **kw)[1].sum())

    return run


def time_rollout(tracker, args, label, dev):
    """ms per frame-batch of the scoreboard's rollout, median of
    ``args.repeats`` timed runs after one warm-up (whose launches are
    :func:`uncounted`)."""
    run = rollout(tracker, args, dev)
    T = args.frames
    t0 = time.perf_counter()
    with uncounted():
        n_emit = run()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(args.repeats):
        _sync(dev)
        t0 = time.perf_counter()
        run()
        _sync(dev)
        times.append((time.perf_counter() - t0) / T * 1e3)
    ms = float(np.median(times))
    print(f"{label:28s} {ms:8.3f} ms/frame-batch (spread {min(times):.3f}-"
          f"{max(times):.3f} over {args.repeats})  "
          f"({args.streams * 1e3 / ms / 30:,.0f} streams@30fps, {n_emit} "
          f"emissions, first rollout {first_s:.1f} s)", flush=True)
    return ms


@contextlib.contextmanager
def patched(mod, replacements):
    """``mod``'s attributes set to ``replacements`` ({name: value}) inside
    the block, the originals restored after it, also when it raises."""
    saved = {attr: getattr(mod, attr) for attr in replacements}
    try:
        for attr, value in replacements.items():
            setattr(mod, attr, value)
        yield
    finally:
        for attr, value in saved.items():
            setattr(mod, attr, value)


def device_shares(tracker, args, dev, mod):
    """One rollout of the unstubbed ``tracker`` split by device time
    (``utils/profiling.py::device_split``), each stage of
    :func:`make_stubs` that ``mod`` has in a range named after it; prints
    and returns {"device_ms", "wall_ms" (a frame-batch's), "busy" (the
    device's share of the wall), "stages": {stage: (device ms a
    frame-batch, share of the device time)}}."""
    stages = {name: attr for name, (attr, _) in make_stubs().items()
              if hasattr(mod, attr)}
    ranges = {}
    for name, attr in stages.items():
        orig = getattr(mod, attr)
        if name == "asso":
            ranges[attr] = (lambda *a, orig=orig, **kw:
                            ranged(orig(*a, **kw), "asso"))
        else:
            ranges[attr] = ranged(orig, name)
    with patched(mod, ranges):
        split = device_split(rollout(tracker, args, dev), list(stages))
    T, device_ms = args.frames, split["device_ms"]
    out = {"device_ms": device_ms / T, "wall_ms": split["wall_ms"] / T,
           "busy": device_ms / split["wall_ms"], "stages": {}}
    print(f"device split of one rollout: {out['device_ms']:.3f} device ms "
          f"a frame-batch in {out['wall_ms']:.3f} ms of wall under the "
          f"profiler (device busy {100 * out['busy']:.1f}%, "
          f"{split['kernels']} kernels)", flush=True)
    for name, ms in split["labels"].items():
        ms = ms or 0.0
        out["stages"][name] = (ms / T, ms / device_ms)
        print(f"  {name:10s} {ms / T:8.3f} device ms/frame-batch "
              f"({100 * ms / device_ms:5.1f}% of the device time)",
              flush=True)
    rest = device_ms - sum(v or 0.0 for v in split["labels"].values())
    print(f"  {'the rest':10s} {rest / T:8.3f} device ms/frame-batch "
          f"({100 * rest / device_ms:5.1f}%; nested stages counted in "
          f"each)", flush=True)
    return out


def make_stubs():
    """{ablation: (model attribute, stub)}: cheap same-shape substitutes
    for the hot stages, batched over the leading (stream) dimensions as
    the port's trackers call them."""

    def lap_stub(cost, row_mask, col_mask, thresh, impl="jv"):
        # an argmin, no loop: not a valid assignment, the same shapes
        r2c = torch.where(row_mask, cost.argmin(-1).to(torch.int32), -1)
        c2r = torch.where(col_mask, cost.argmin(-2).to(torch.int32), -1)
        return r2c, c2r

    def iou_stub(a, b):
        # one broadcast subtraction in place of the IoU algebra
        return (a[..., :, None, 0] - b[..., None, :, 0]) * 1e-4

    def asso_stub(name, frame_width=1920, frame_height=1080):
        # get_asso_fn's call, returning iou_stub
        return iou_stub

    def kf_predict_stub(x, P, params=None):
        return x, P

    def kf_update_stub(x, P, z, params=None):
        return x + 1e-12 * z.sum(-1, keepdim=True), P

    def ring_stub(obs_ring, obs_age, age, delta_t):
        # the ring's first slot (skips the delta_t search)
        return obs_ring[..., 0, :]

    def apply_stub(v, t2d, dets, frame_age, delta_t, kf):
        # keep a tiny data dependency, so the matches are still computed
        dep = t2d.sum()
        for k, t in v.items():
            if t.is_floating_point():
                v[k] = t + 0 * dep.to(t.dtype)

    return {
        "lap": ("solve_lap_masked", lap_stub),
        "iou": ("iou_batch", iou_stub),
        "asso": ("get_asso_fn", asso_stub),
        "kf_predict": ("xysr_predict", kf_predict_stub),
        "kf_update": ("xysr_update", kf_update_stub),
        "ring": ("_k_previous_obs", ring_stub),
        "apply": ("_observe", apply_stub),
    }


def counted(fn, calls, name):
    """fn, adding one to ``calls[name]`` each call."""

    def wrapper(*a, **kw):
        calls[name] += 1
        return fn(*a, **kw)

    return wrapper


def ablate(args):
    """The baseline, its device split on the card and each ablation;
    returns {"device", "baseline": ms, "split": :func:`device_shares`'s
    report or None on the CPU, "rows": [(ablation, ms, share ms)],
    "calls": {ablation: n}, "skipped": [ablation]}. Raises if an ablated stub was never called;
    the model module's attributes are the originals again in any case."""
    from motcpp_tpu_torch.device import resolve_device

    dev = torch.device("cpu") if args.cpu else resolve_device("cuda")
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (host times, not the card's)")
    print(f"{args.tracker} S={args.streams} T={args.frames} "
          f"K={args.max_tracks} N={args.max_dets} lap={args.lap} on {where}",
          flush=True)
    mod = importlib.import_module(f"motcpp_tpu_torch.models.{args.tracker}")
    report = {"device": where, "rows": [], "calls": {}, "skipped": [],
              "split": None}
    base = report["baseline"] = time_rollout(args.tracker, args, "baseline",
                                             dev)
    if dev.type == "cuda":
        report["split"] = device_shares(args.tracker, args, dev, mod)
    else:
        print("device split: not measured on the CPU", flush=True)
    stubs = make_stubs()
    for name in args.ablate:
        if name not in stubs:
            print(f"# no stub for {name}; skipping")
            report["skipped"].append(name)
            continue
        attr, fn = stubs[name]
        if not hasattr(mod, attr):
            print(f"# {args.tracker} does not use {attr}; skipping")
            report["skipped"].append(name)
            continue
        calls = {name: 0}
        with patched(mod, {attr: counted(fn, calls, name)}):
            ms = time_rollout(args.tracker, args, f"- {name}", dev)
        report["calls"][name] = calls[name]
        if not calls[name]:
            raise RuntimeError(
                f"the {name} stub ({args.tracker}.{attr}) was never called: "
                "the tracker does not reach the stage through its module")
        report["rows"].append((name, ms, base - ms))
        print(f"  -> {name} share: {base - ms:+.3f} ms "
              f"({(base - ms) / base * 100:.0f}%; stub called {calls[name]} "
              f"times)", flush=True)
    return report


def main(argv=None):
    return ablate(parser().parse_args(argv))


if __name__ == "__main__":
    main()
