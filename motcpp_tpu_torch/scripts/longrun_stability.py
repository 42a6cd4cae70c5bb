#!/usr/bin/env python3
"""Long-horizon streaming stability: thousands of frames of carried-state
tracking.

Counterpart of the JAX package's ``scripts/longrun_stability.py``. It
exercises what the short runs cannot: observation rings wrap hundreds of
times, id counters grow for thousands of frames, lost-track aging and
rebirth cycle, and the carried state crosses every ``run()`` call of
``parallel/streams.py::MultiStreamRunner``, one call a chunk. The
detections are made on the tracker's device (:func:`make_device_scene`:
cumulative sums over a chunk's frames, no per-frame host work), so the
run measures the tracker, not copies from the host.

Checks per chunk: every emitted row finite (exit 1 with ``FAIL:
non-finite emission in chunk c`` otherwise). Non-finite floating-point
state fields are reported in the summary line without failing, as in the
JAX package: NaNs may live in dead slots. Beside the JAX script's summary
it reports ms per frame-batch of each chunk (the runner's call, the card
synchronised around it), the largest emitted id and the largest
``next_id``.

Usage:
  python -m motcpp_tpu_torch.scripts.longrun_stability [--tracker bytetrack] [--streams 256] [--frames 10000] [--chunk 500]
  python -m motcpp_tpu_torch.scripts.longrun_stability --cpu --streams 4 --frames 60 --chunk 20

It runs on the CUDA device with ``--lap auction_pallas`` (the auction
CUDA kernel) and raises without one unless given ``--cpu`` (the plain
auction, and the host's times).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--tracker", default="bytetrack")
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--frames", type=int, default=10000)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--max-tracks", type=int, default=64)
    ap.add_argument("--max-dets", type=int, default=32)
    ap.add_argument("--lap", default="auction_pallas")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    return ap


def make_device_scene(S, N, n_obj=16, device="cuda"):
    """The JAX script's synthetic scene on ``device``: ``init(gen)`` draws
    the objects' state (centres (S, n_obj, 2), velocities, sizes) and
    ``chunk(gen, state, T)`` advances it T frames, returning ``(state,
    dets (T, S, N, 6), masks (T, S, N))``; ``gen`` is a
    ``torch.Generator`` on ``device``. Centres in a 1920x1080 frame 100
    px from its edges, constant velocity with jitter (sigma 1.0 in x,
    0.5 in y), 5% dropout and confidences uniform in [0.5, 1): the
    statistics of ``data/synthetic.py::synth_stream_dets``.
    The draws are torch's, so the boxes are not the JAX script's."""
    dev = resolve_device(device)
    n_obj = min(n_obj, N)
    lo = torch.tensor([100.0, 100.0], device=dev)
    span = torch.tensor([1920.0 - 200.0, 1080.0 - 200.0], device=dev)
    v_scale = torch.tensor([1.0, 0.6], device=dev)
    wh_lo = torch.tensor([40.0, 80.0], device=dev)
    wh_span = torch.tensor([80.0, 160.0], device=dev)
    jitter = torch.tensor([1.0, 0.5], device=dev)

    def uniform(gen, shape):
        return torch.rand(shape, generator=gen, device=dev)

    def init(gen):
        c = lo + span * uniform(gen, (S, n_obj, 2))
        v = (uniform(gen, (S, n_obj, 2)) * 10.0 - 5.0) * v_scale
        wh = wh_lo + wh_span * uniform(gen, (S, n_obj, 2))
        return c, v, wh

    def chunk(gen, state, T):
        c, v, wh = state
        noise = torch.randn((T, S, n_obj, 2), generator=gen,
                            device=dev) * jitter
        centres = c + torch.cumsum(v + noise, 0)  # (T, S, n_obj, 2)
        visible = uniform(gen, (T, S, n_obj)) > 0.05
        conf = 0.5 + 0.5 * uniform(gen, (T, S, n_obj))
        half = wh * 0.5
        dets = torch.zeros((T, S, N, 6), device=dev)
        dets[..., :n_obj, 0:2] = centres - half
        dets[..., :n_obj, 2:4] = centres + half
        dets[..., :n_obj, 4] = conf
        masks = torch.zeros((T, S, N), dtype=torch.bool, device=dev)
        masks[..., :n_obj] = visible
        return (centres[-1], v, wh), dets, masks

    return init, chunk


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, scene=None, on_chunk=None) -> dict:
    """The long run that ``args`` (from :func:`parser`) describe; returns
    the report.

    ``scene``: None (each chunk made on the device by
    :func:`make_device_scene` from a generator seeded 0) or ``(dets,
    masks)`` over at least ``n_chunks * chunk`` frames, cut into the
    chunks. ``on_chunk(c, runner, dets, masks, outs, out_masks)``, if
    given, is called after each chunk's check.

    The report: ``device``, ``tracker``, ``streams``, ``frames`` (the
    chunks' frames), ``n_chunks``, ``chunk_ms`` (ms per frame-batch of
    each chunk's ``run()``), ``emissions``, ``max_emitted_id``,
    ``max_next_id``, ``nonfinite_leaves`` (indices of the state's
    floating-point fields holding a non-finite value), ``failed`` (the
    first chunk with a non-finite emitted row, or None: the run stops
    there), ``wall_s``, ``summary`` (the printed line) and ``states``
    (the carried state)."""
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    dev = resolve_device("cpu" if args.cpu else "cuda")
    S, N, T = args.streams, args.max_dets, args.chunk
    init_fn, step_fn = build_tracker_fns(args.tracker, args.max_tracks, N,
                                         args.lap, device=dev)
    runner = MultiStreamRunner(init_fn, step_fn, S, device=dev)
    n_chunks = -(-args.frames // T)
    if scene is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        scene_init, scene_chunk = make_device_scene(S, N, device=dev)
        scene_state = scene_init(gen)
    else:
        all_dets = torch.as_tensor(scene[0], dtype=torch.float32, device=dev)
        all_masks = torch.as_tensor(scene[1], dtype=torch.bool, device=dev)
        if all_dets.shape[0] < n_chunks * T:
            raise ValueError(f"the scene has {all_dets.shape[0]} frames, "
                             f"the run needs {n_chunks * T}")
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    report = {"device": device_name, "tracker": args.tracker, "streams": S,
              "frames": n_chunks * T, "n_chunks": n_chunks, "chunk_ms": [],
              "emissions": 0, "max_emitted_id": None, "failed": None}
    max_id = torch.tensor(float("-inf"), device=dev)
    t_start = time.perf_counter()
    for c in range(n_chunks):
        if scene is None:
            scene_state, dets, masks = scene_chunk(gen, scene_state, T)
        else:
            dets, masks = all_dets[c * T:(c + 1) * T], \
                all_masks[c * T:(c + 1) * T]
        _sync(dev)
        t0 = time.perf_counter()
        outs, out_masks = runner.run(dets, masks)
        _sync(dev)
        ms = (time.perf_counter() - t0) / T * 1e3
        report["chunk_ms"].append(ms)
        if bool((out_masks & ~torch.isfinite(outs).all(-1)).any()):
            print(f"FAIL: non-finite emission in chunk {c}", flush=True)
            report["failed"] = c
            break
        n_emit = int(out_masks.sum())
        report["emissions"] += n_emit
        ids = torch.where(out_masks, outs[..., 4], float("-inf"))
        max_id = torch.maximum(max_id, ids.max())
        print(f"chunk {c}: {ms:.3f} ms per frame-batch, {n_emit} emissions, "
              f"largest id so far {float(max_id):.0f}", flush=True)
        if on_chunk is not None:
            on_chunk(c, runner, dets, masks, outs, out_masks)
    wall = time.perf_counter() - t_start
    states = runner.states
    bad = [p for p, leaf in enumerate(states) if leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    # NaNs may legitimately live in DEAD slots (the reference prunes NaN
    # tracks rather than preventing them)
    report.update(
        max_emitted_id=(int(max_id) if report["emissions"] else None),
        max_next_id=int(states.next_id.max()), nonfinite_leaves=bad,
        wall_s=wall, states=states)
    if report["failed"] is None:
        report["summary"] = (
            f"{args.tracker}: {report['frames']:,} frames x {S} streams "
            f"stable — {report['emissions']:,} emissions, wall {wall:.0f}s "
            f"(every chunk's emitted rows checked finite on {device_name}; "
            f"ms per frame-batch "
            f"{min(report['chunk_ms']):.3f}-{max(report['chunk_ms']):.3f} "
            f"over the chunks, largest emitted id "
            f"{report['max_emitted_id']}, largest next_id "
            f"{report['max_next_id']})"
            f"{' [nonfinite leaves: ' + str(bad) + ']' if bad else ''}")
        print(report["summary"], flush=True)
    return report


def main(argv=None):
    return 1 if run(parser().parse_args(argv))["failed"] is not None else 0


if __name__ == "__main__":
    sys.exit(main())
