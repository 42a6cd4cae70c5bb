#!/usr/bin/env python3
"""Find the live-ReID serving configurations that meet the tick SLO.

Counterpart of the JAX package's ``scripts/slo_sweep.py``. A deployment
meets 30 FPS only if its p99 tick latency is at most 33 ms. For each
appearance tracker at its deployed live-ReID operating point (bench.py
DEPLOYED: an embedding cadence or a priority budget), the sweep walks
the stream count down its ladder until the measured p99 meets the SLO,
and records every point it ran. Each point is
:mod:`motcpp_tpu_torch.scripts.serving_latency` run in this process
(``--live-reid --pipeline --pipeline-depth 4 --device-data``), with one
OSNet built per live-ReID configuration and reused down the ladders.

Before the walk, a null row (ByteTrack S=8, motion-only, depth 4) gives
the per-tick dispatch floor, and each point's p99 is also reported net
of the floor's p99; after it, one row with producer threads submitting
through the native mux (StrongSORT S=8) prices host ingest. A point
that raises becomes an ``error`` row, as a failed run of the JAX script
does (the null and producer rows too, where the JAX script leaves a
failed one out).

Usage:
  python -m motcpp_tpu_torch.scripts.slo_sweep            # on the card
  python -m motcpp_tpu_torch.scripts.slo_sweep --tracker strongsort --out /tmp/slo.json
  python -m motcpp_tpu_torch.scripts.slo_sweep --cpu --ticks 4

It writes ``--out`` (default ``motcpp_tpu_torch/_build/serving_slo_torch.json``)
and prints one JSON line last.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

from motcpp_tpu_torch.scripts import serving_latency

OUT = Path(__file__).resolve().parent.parent / "_build" / "serving_slo_torch.json"

# the deployed live-ReID operating points (bench.py DEPLOYED)
DEPLOYED = {
    "strongsort": ["--emb-priority", "0.6"],
    "botsort": ["--emb-cadence", "8"],
    "deepocsort": ["--emb-cadence", "8"],
    "boosttrack": ["--emb-cadence", "2"],
    "hybridsort": ["--emb-priority", "0.8"],
}

# stream-count ladders, walked down until p99 passes
LADDER = {
    "strongsort": [32, 16, 8],
    "hybridsort": [32, 16, 8],
    "boosttrack": [64, 32, 16],
    "botsort": [128, 64, 32],
    "deepocsort": [128, 64, 32],
}

SLO_MS = 33.0


class Harness:
    """``harness(argv) -> row``: the serving harness on ``argv`` in this
    process, building each live-ReID embed once. ``on_run(args, row,
    report)``, if given, sees every run's args, row and
    ``serving_latency.measure`` report."""

    def __init__(self, on_run=None):
        self.on_run = on_run
        self._embeds = {}

    def __call__(self, argv: list[str]) -> dict:
        args = serving_latency.parser().parse_args(argv)
        embed = None
        if args.live_reid:
            key = (args.reid_variant, args.reid_quant, args.cpu)
            if key not in self._embeds:
                device = torch.device("cpu" if args.cpu else "cuda")
                self._embeds[key] = serving_latency.build_embed(args, device)
            embed = self._embeds[key]
        report = {}
        try:
            row = serving_latency.measure(args, embed=embed, report=report)
        finally:
            gc.collect()  # the point's staged ring goes before the next
        if self.on_run is not None:
            self.on_run(args, row, report)
        return row


def point_argv(tracker: str, streams: int, extra: list[str], ticks: int,
               cpu: bool) -> list[str]:
    argv = ["--tracker", tracker, "--streams", str(streams),
            "--live-reid", "--pipeline", "--pipeline-depth", "4",
            "--device-data", "--max-dets", "16", "--objects", "14",
            "--ticks", str(ticks)] + extra
    return argv + ["--cpu"] if cpu else argv


def null_argv(ticks: int, cpu: bool) -> list[str]:
    argv = ["--tracker", "bytetrack", "--streams", "8", "--max-dets", "8",
            "--max-tracks", "16", "--objects", "4", "--pipeline",
            "--pipeline-depth", "4", "--device-data", "--ticks", str(ticks)]
    return argv + ["--cpu"] if cpu else argv


def producer_argv(cpu: bool) -> list[str]:
    argv = ["--tracker", "strongsort", "--streams", "8", "--live-reid",
            "--pipeline", "--max-dets", "16", "--objects", "14",
            "--ticks", "40"] + DEPLOYED["strongsort"]
    return argv + ["--cpu"] if cpu else argv


def attempt(run, argv, label: str):
    """``run(argv)``, or None and a message if it raised."""
    try:
        return run(argv), None
    except Exception as exc:  # a failed point is a row of the sweep
        msg = f"{type(exc).__name__}: {exc}"
        print(f"# [{label}] FAILED: {msg}", file=sys.stderr, flush=True)
        return None, msg[-300:]


def run_point(tracker: str, streams: int, extra: list[str], ticks: int,
              cpu: bool, run) -> dict:
    row, err = attempt(run, point_argv(tracker, streams, extra, ticks, cpu),
                       f"{tracker} S={streams}")
    if row is None:
        return {"tracker": tracker, "streams": streams, "error": err}
    row["tracker"] = tracker
    row["slo_ms"] = SLO_MS
    row["meets_slo"] = row["p99"] <= SLO_MS
    return row


def card_meta(cpu: bool) -> str:
    if cpu:
        return "cpu"
    return (f"{torch.cuda.get_device_name(0)}, "
            f"{serving_latency.card_power_limit()}")


def sweep(tracker: str = "", ticks: int = 300, cpu: bool = False,
          run=None) -> dict:
    """The sweep's record: ``{"_meta", "summary", "rows"}``. ``tracker``
    sweeps only that tracker (no null or producer row); ``run(argv) ->
    row`` drives the harness (default: a :class:`Harness`)."""
    if not cpu:
        from motcpp_tpu_torch.device import resolve_device

        resolve_device("cuda")  # no card: raise before anything runs
    run = run or Harness()
    trackers = [tracker] if tracker else list(DEPLOYED)
    rows = []
    summary = {}

    # Null row: a minimal motion-only tick at the same pipeline depth;
    # its p99 is the per-tick dispatch floor, netted out of each point's
    floor = None
    if not tracker:
        floor, err = attempt(run, null_argv(ticks, cpu), "null row")
        if floor is None:
            rows.append({"role": "dispatch_floor_null_row", "error": err})
        else:
            floor["role"] = "dispatch_floor_null_row"
            rows.append(floor)
        print(f"# null-row floor: {floor and floor['p50']} ms p50",
              file=sys.stderr, flush=True)
    for trk in trackers:
        best = None
        for streams in LADDER[trk]:
            row = run_point(trk, streams, DEPLOYED[trk], ticks, cpu, run)
            if floor is not None and "p99" in row:
                # equal-quantile netting: p99 - floor p99 estimates the
                # compute's shift at the tail
                row["p99_net_of_floor"] = round(
                    row["p99"] - floor["p99"], 2)
                row["meets_slo_net"] = row["p99_net_of_floor"] <= SLO_MS
            rows.append(row)
            if row.get("meets_slo") or row.get("meets_slo_net"):
                best = row
                break  # the largest passing point on the ladder
        summary[trk] = (
            {"streams": best["streams"], "p50": best["p50"],
             "p99": best["p99"],
             "p99_net_of_floor": best.get("p99_net_of_floor"),
             "e2e_p99_ms": best.get("e2e_p99_ms")}
            if best else "NO PASSING POINT"
        )
        print(f"# {trk}: {summary[trk]}", file=sys.stderr, flush=True)

    if not tracker:
        # one row with producer threads submitting through the native
        # mux and the crops copied to the card: host ingest priced
        row, err = attempt(run, producer_argv(cpu), "strongsort e2e")
        row = row or {"error": err}
        row["tracker"] = "strongsort"
        row["mode"] = "e2e_producers"
        rows.append(row)

    return {
        "_meta": {
            "slo": "p99 tick latency <= 33 ms",
            "harness": "python -m motcpp_tpu_torch.scripts.serving_latency "
                       "--live-reid --pipeline --pipeline-depth 4 "
                       "--device-data, the deployed operating points "
                       "(bench.py DEPLOYED), max_dets=16 objects=14",
            "card": card_meta(cpu),
            "mode": "device-data: a ring of tick inputs staged on the "
                    "device, handed to the service as tensors: the "
                    "serving step's latency with host ingest excluded. "
                    "The e2e_producers row has producer threads on the "
                    "card's host submitting through the native mux, the "
                    "crops copied to the card each tick.",
            "sweep": "python -m motcpp_tpu_torch.scripts.slo_sweep",
        },
        "summary": summary,
        "rows": rows,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--tracker", default="", choices=[""] + list(DEPLOYED),
                    help="sweep only this tracker")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    out = sweep(args.tracker, args.ticks, args.cpu)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"metric": "serving_slo_sweep",
                      "passing": sum(1 for v in out["summary"].values()
                                     if isinstance(v, dict)),
                      "total": len(out["summary"])}))


if __name__ == "__main__":
    main()
