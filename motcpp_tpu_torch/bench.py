"""Throughput scoreboard of the port: concurrent 30-FPS tracking streams
per card.

Counterpart of the JAX package's ``bench.py``, with its rows, flags and
defaults. S synthetic streams (``data/synthetic.py::synth_stream_dets``,
seed 0: about 16 jittered constant-velocity boxes a frame, 5% dropout)
are tracked for T frames through ``MultiStreamRunner``; the median of
``--repeats`` timed rollouts after one warm-up gives aggregate frames a
second, reported as streams sustainable at 30 FPS. The tracker state
carries from the warm-up through the repeats (continuous streaming, as
``bench.py::_time_rollout``), and the card is synchronised around each
rollout (``utils/benchrun.py::timed_runs``).

Default (no ``--tracker``): the whole scoreboard, one JSON row a line:
the eight trackers but ByteTrack at their saturation points (S=4096 for
SORT, 2048 for the others), the capacity rows (``CAPACITY_ROWS`` x
``CAPACITY_TRACKERS``), the live-ECC StrongSORT row, StrongSORT's
every-frame bf16 live-ReID row and the five ``DEPLOYED`` live-ReID
points, each of those seven in a fresh process, and the ByteTrack
flagship last::

  {"metric": "torch_<tracker>_streams_at_30fps_per_chip", "value": N,
   "unit": "streams_at_30fps_per_chip", "vs_baseline": N / 256}

The metric names take the prefix ``torch_``, so that no row reads as the
JAX package's. The rows are also written to
``motcpp_tpu_torch/_build/bench_full_torch.json`` (``--quick`` or
``--cpu``: ``_build/bench_quick_torch.json``); the JAX package's
``BENCH_*.json`` files are never written. A leg that fails or times out
is recorded as an error row, and the script then exits 1.

Beside ``bench.py``'s flags, ``--fused`` runs the live-ReID OSNet with
every OSBlock through the OSBlock CUDA kernel (``make_embed_fn(...,
fused=True)``; the metric takes ``_fused`` after the variant and
``_int8`` place); without it the live rows run the BN-folded forward, as
``bench.py``. ``--dw-impl`` takes only ``conv``: the port has one
depthwise schedule. On the card ``--lap auction_pallas`` (the default)
is the auction CUDA kernel, and every row checks that it launched; on
the CPU (``--cpu``) the wrappers run their plain versions.

Usage:
  python -m motcpp_tpu_torch.bench                     # the whole scoreboard
  python -m motcpp_tpu_torch.bench --quick             # the nine tracker rows
  python -m motcpp_tpu_torch.bench --tracker strongsort --livereid --emb-priority 0.6 --fused
  python -m motcpp_tpu_torch.bench --cpu --quick --streams 8 --frames 4 --repeats 1 --max-tracks 16 --max-dets 8 --objects 4
"""

from __future__ import annotations

import argparse
import copy
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from motcpp_tpu_torch.data.synthetic import pan_frames, synth_stream_dets
from motcpp_tpu_torch.device import resolve_device
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from motcpp_tpu_torch.scripts.tracker_fns import TRACKERS, build_tracker_fns
from motcpp_tpu_torch.utils.benchrun import rolled_crops, timed_runs

PACKAGE = Path(__file__).resolve().parent
BUILD = PACKAGE / "_build"
FULL_JSON, QUICK_JSON = "bench_full_torch.json", "bench_quick_torch.json"
PREFIX = "torch_"

# flagship LAST: a single-line (tail -1) parse lands on bytetrack
ALL_TRACKERS = TRACKERS

# bench.py's saturation points: the motion-light trackers at S=4096, the
# heavier ones at S=2048, the live-CMC rows at 512 (a (T, S, h, w) frame
# tensor on the card), the live-ReID rows at 128
DEFAULT_STREAMS = {"sort": 4096, "bytetrack": 4096}
DEFAULT_STREAMS_OTHER = 2048
CMC_STREAMS, CMC_SCALE = 512, 0.15
# the live-ReID rows' shape (bench.py:378-381): crops, embedding width,
# frames, detection and track slots, objects
LIVE_HW, LIVE_D, LIVE_T, LIVE_N, LIVE_K, LIVE_OBJ = (256, 128), 512, 4, 16, 64, 14
LIVE_STREAMS = 128
# OSBlocks in every OSNet variant: under --fused each embedded frame (one
# embed call a frame) launches the OSBlock kernel this many times
OSBLOCKS = 6

# bench.py's capacity rows: (suffix, overrides), S cut to 1024
CAPACITY_ROWS = [
    ("_K128_N64", dict(streams=1024, max_tracks=128, max_dets=64,
                       objects=40)),
    ("_K128_N128", dict(streams=1024, max_tracks=128, max_dets=128,
                        objects=64)),
]
CAPACITY_TRACKERS = ["strongsort", "boosttrack", "bytetrack"]

# bench.py's deployed live-ReID operating points
DEPLOYED = {
    "strongsort": ["--emb-priority", "0.6"],
    "botsort": ["--emb-cadence", "8"],
    "deepocsort": ["--emb-cadence", "8"],
    "boosttrack": ["--emb-cadence", "2"],
    "hybridsort": ["--emb-priority", "0.8"],
}

LEG_TIMEOUT = 2400  # seconds a fresh-process leg may take


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m motcpp_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--tracker", default="", choices=[""] + list(ALL_TRACKERS),
                    help="single tracker to benchmark; default: the whole "
                    "scoreboard, bytetrack last")
    ap.add_argument("--all", action="store_true",
                    help="the whole scoreboard (the default)")
    ap.add_argument("--streams", type=int, default=0,
                    help="stream count (0 = the row's saturation default; "
                    "caps the capacity rows)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--max-tracks", type=int, default=64)
    ap.add_argument("--max-dets", type=int, default=32)
    ap.add_argument("--objects", type=int, default=16)
    ap.add_argument("--lap", default="auction_pallas",
                    choices=["jv", "auction", "auction_pallas"],
                    help="assignment: auction_pallas is the auction CUDA "
                    "kernel on the card (its plain version on the CPU), "
                    "auction the plain auction, jv the exact JV")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (without it, a missing card raises)")
    ap.add_argument("--quick", action="store_true",
                    help="the nine tracker rows only")
    ap.add_argument("--emb-dim", type=int, default=0,
                    help="feed random unit embeddings of this width through "
                    "the rollout (appearance trackers)")
    ap.add_argument("--reid-variant", default="x1_0",
                    choices=["x1_0", "x0_75", "x0_5", "x0_25"],
                    help="OSNet width of the live-ReID rows")
    ap.add_argument("--dw-impl", default="conv", choices=["conv", "shift"],
                    help="OSNet depthwise schedule: the port has only conv")
    ap.add_argument("--fused", action="store_true",
                    help="live-ReID rows: every OSBlock through the OSBlock "
                    "CUDA kernel (make_embed_fn fused=True); default the "
                    "BN-folded forward, as bench.py")
    ap.add_argument("--crop-budget", type=int, default=0,
                    help="cap the live-ReID CNN batch at this many crops a "
                    "frame (N raised to 32; 0 = every det slot)")
    ap.add_argument("--reid-quant", action="store_true",
                    help="live-ReID CNN in int8 (appearance/quant.py)")
    ap.add_argument("--emb-priority", type=float, default=0.0,
                    help="embed this fraction of det slots a frame, chosen "
                    "by embedding priority (replaces --emb-cadence)")
    ap.add_argument("--emb-cadence", type=int, default=0,
                    help="embed each stream's crops every k-th frame")
    ap.add_argument("--livereid", action="store_true",
                    help="with --tracker: the tracker's live-ReID row")
    ap.add_argument("--merge-full", action="store_true",
                    help="with --tracker: merge the row into "
                    f"_build/{FULL_JSON} by metric")
    ap.add_argument("--metric-suffix", default="",
                    help="suffix of the metric name with --tracker")
    ap.add_argument("--cmc", nargs="?", const="warps", default="",
                    choices=["", "warps", "ecc", "sof"],
                    help="warps: per-frame camera-jitter warps through the "
                    "rollout; ecc/sof: live camera motion from 0.15x frames "
                    "made on the card (warp-capable trackers only)")
    return ap


def device_of(args) -> torch.device:
    """The CPU under ``--cpu``, else the card (raising where there is
    none)."""
    return torch.device("cpu") if args.cpu else resolve_device("cuda")


def card(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _counters():
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.ops import auction_cuda

    return {"auction": auction_cuda, "OSBlock": osblock_cuda}


def _timed(runner, args, dev, label, dets, masks, report, kernels, **legs):
    """timed_runs without reset over the row's inputs: (median seconds,
    run seconds, launches of each kernel over all runs). On the card each
    kernel of ``kernels`` must have launched, at least once a frame of
    every run for the auction kernel and OSBLOCKS times a frame of every
    run for the OSBlock kernel (no row falls back to a plain version). ``report``, if given, receives the runner and its device
    inputs (``runner``, ``device_inputs``: dets, masks and the run()
    keywords), the first and last runs' outputs (``first``, ``last``),
    the launches and the timed runs' seconds."""
    counters = _counters()
    before = {k: m.LAUNCHES for k, m in counters.items()}
    run_s, times, first, (outs, out_masks) = timed_runs(
        runner, dets, masks, label=label, repeats=args.repeats, reset=False,
        **legs)
    launches = {k: m.LAUNCHES - before[k] for k, m in counters.items()}
    runs = 1 + args.repeats
    if dev.type == "cuda":
        frames = runs * dets.shape[0]
        least = {"auction": frames, "OSBlock": OSBLOCKS * frames}
        for k in kernels:
            if launches[k] < least[k]:
                raise RuntimeError(
                    f"[{label}] {launches[k]} {k} kernel launches over "
                    f"{runs} runs, want at least {least[k]}: the row did not "
                    "run through the kernel")
    emitted = int(out_masks.sum())
    if emitted == 0:
        print(f"# [{label}] WARNING: no tracks emitted - check inputs",
              file=sys.stderr)
    if report is not None:
        report.update(runner=runner, device_inputs=(dets, masks, legs),
                      first=first, last=(outs, out_masks), launches=launches,
                      times=times)
    return run_s, times, launches


def _runs_line(run_s, times, launches):
    return (f"median of {len(times)} runs "
            f"{[round(t * 1e3, 3) for t in times]} ms = {run_s * 1e3:.3f} ms; "
            "launches " + ", ".join(f"{k} {n}" for k, n in launches.items()))


def bench_one(tracker: str, args, overrides: dict | None = None,
              metric_suffix: str = "", report: dict | None = None) -> dict:
    """One tracker's row (``bench.py::bench_one``). ``overrides``: the
    capacity rows' {streams, max_tracks, max_dets, objects}. ``report``,
    if given, receives the host inputs (``inputs``: S, dets, masks and
    the run() keywords as numpy arrays) and what :func:`_timed` reports."""
    if overrides:
        args = copy.copy(args)
        for k, v in overrides.items():
            setattr(args, k, v)
    dev = device_of(args)
    init_fn, step_fn = build_tracker_fns(tracker, args.max_tracks,
                                         args.max_dets, args.lap,
                                         emb_dim=args.emb_dim, device=dev)
    cmc_mode = str(getattr(args, "cmc", "") or "")
    cmc_live = cmc_mode in ("ecc", "sof")
    S = args.streams or (CMC_STREAMS if cmc_live else DEFAULT_STREAMS.get(
        tracker, DEFAULT_STREAMS_OTHER))
    T, N = args.frames, args.max_dets
    rng = np.random.default_rng(0)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=args.objects)

    with_embs = args.emb_dim > 0
    warp_capable = "warp" in inspect.signature(step_fn).parameters
    with_warps = cmc_mode == "warps" and warp_capable
    cmc_fn = None
    if cmc_live and warp_capable:
        # live camera motion from each stream's frames, estimated on the
        # device at the reference's 0.15x scale
        from motcpp_tpu_torch.motion.cmc import ecc_jax_batch, sof_jax_batch

        cmc_fn = ecc_jax_batch if cmc_mode == "ecc" else sof_jax_batch
    runner = MultiStreamRunner(init_fn, step_fn, S, device=dev,
                               with_embs=with_embs, with_warps=with_warps,
                               cmc_fn=cmc_fn, cmc_scale=CMC_SCALE)
    host_kw = {}
    if with_embs:
        e = rng.normal(0, 1, (T, S, N, args.emb_dim)).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True) + 1e-9
        host_kw["embs"] = e
    if with_warps:
        # small per-frame camera jitter: rotation + translation
        ang = rng.normal(0, 0.002, (T, S)).astype(np.float32)
        txy = rng.normal(0, 1.5, (T, S, 2)).astype(np.float32)
        w = np.zeros((T, S, 2, 3), np.float32)
        w[..., 0, 0] = np.cos(ang)
        w[..., 0, 1] = -np.sin(ang)
        w[..., 1, 0] = np.sin(ang)
        w[..., 1, 1] = np.cos(ang)
        w[..., :, 2] = txy
        host_kw["warps"] = w
    run_kw = {k: torch.from_numpy(v).to(dev) for k, v in host_kw.items()}
    if cmc_fn is not None:
        # per-stream panning textures, made on the device
        fh, fw = int(1080 * CMC_SCALE), int(1920 * CMC_SCALE)
        run_kw["frames"], _ = pan_frames(
            T, S, fh, fw, torch.Generator(device=dev).manual_seed(0))
    if report is not None:
        report["inputs"] = (S, dets, masks, host_kw)
    label = f"{tracker}{metric_suffix}"
    kernels = ("auction",) if args.lap == "auction_pallas" else ()
    dt, times, launches = _timed(
        runner, args, dev, label, torch.from_numpy(dets).to(dev),
        torch.from_numpy(masks).to(dev), report, kernels, **run_kw)

    agg_fps = S * T / dt
    streams_at_30 = agg_fps / 30.0
    print(f"# [{label}] {card(dev)}: {agg_fps:,.0f} aggregate FPS, "
          f"{dt / T * 1e3:.3f} ms/frame-batch, S={S} K={args.max_tracks} "
          f"N={args.max_dets} T={T}" + (f" cmc={cmc_mode}" if cmc_mode else "")
          + f"; {_runs_line(dt, times, launches)}", file=sys.stderr,
          flush=True)
    return {
        "metric": f"{PREFIX}{label}_streams_at_30fps_per_chip",
        "value": round(streams_at_30, 1),
        "unit": "streams_at_30fps_per_chip",
        "vs_baseline": round(streams_at_30 / 256.0, 3),
    }


def reid_model(variant: str, feature_dim: int):
    """The live-ReID OSNet: ``osnet_<variant>`` with seeded random
    weights (``appearance/osnet.py::init_params``, seed 0)."""
    from motcpp_tpu_torch.appearance import osnet

    return osnet.init_params(
        getattr(osnet, f"osnet_{variant}")(feature_dim=feature_dim), seed=0)


def bench_livereid(tracker: str, args, report: dict | None = None) -> dict:
    """Images in, tracks out (``bench.py::bench_livereid``): raw 256x128
    uint8 crops through OSNet (bf16 on the card, float32 on the CPU;
    int8 under ``--reid-quant``) into the tracker, S=min(128,
    ``--streams``), T=4, N=16, K=64, 14 objects. ``--crop-budget``,
    ``--emb-cadence`` and ``--emb-priority`` set the CNN's load as in
    bench.py; ``--fused`` runs every OSBlock through the OSBlock kernel.
    ``report`` as :func:`bench_one`'s (``inputs``: S, dets, masks and
    the first frame's crops)."""
    from motcpp_tpu_torch.appearance.reid import make_embed_fn

    dev = device_of(args)
    variant = args.reid_variant
    S = min(LIVE_STREAMS, args.streams) if args.streams else LIVE_STREAMS
    T, N, K = LIVE_T, LIVE_N, LIVE_K
    model = reid_model(variant, LIVE_D)
    # bf16 rides the tensor cores on the card; on the CPU float32
    cdt = "bfloat16" if dev.type != "cpu" else "float32"
    if args.reid_quant:
        from motcpp_tpu_torch.appearance.quant import make_embed_fn_int8

        embed = make_embed_fn_int8(model, device=dev)
        cdt = "int8"
    else:
        embed = make_embed_fn(model, compute_dtype=cdt,
                              folded=cdt == "bfloat16", fused=args.fused,
                              device=dev)

    budget = int(args.crop_budget or 0)
    if budget:
        # size the det axis for peaks, pay the CNN only for the budget
        N = max(N, 32)
    cadence = int(args.emb_cadence or 0)
    pri_frac = float(args.emb_priority or 0.0)
    if pri_frac:
        # a fixed fraction of the det slots, filled by embedding priority
        cadence = 0
        budget = max(budget or 0, int(round(pri_frac * S * N)))
    init_fn, step_fn = build_tracker_fns(tracker, K, N, args.lap,
                                         emb_dim=LIVE_D, device=dev)
    runner = MultiStreamRunner(init_fn, step_fn, S, device=dev,
                               embed_fn=embed, crop_budget=budget or None,
                               emb_cadence=cadence or None,
                               emb_priority=bool(pri_frac))
    rng = np.random.default_rng(0)
    dets, masks = synth_stream_dets(rng, T, S, N, n_obj=LIVE_OBJ)
    # one frame of crops drawn on the host, the time axis made on the
    # device by rolling it along the stream axis
    crops0 = rng.integers(0, 255, (S, N) + LIVE_HW + (3,)).astype(np.uint8)
    crops = rolled_crops(torch.from_numpy(crops0).to(dev), T)
    if report is not None:
        report["inputs"] = (S, dets, masks, {"crops0": crops0})
    label = f"{tracker}_livereid"
    kernels = (("auction",) if args.lap == "auction_pallas" else ()) + (
        ("OSBlock",) if args.fused else ())
    dt, times, launches = _timed(
        runner, args, dev, label, torch.from_numpy(dets).to(dev),
        torch.from_numpy(masks).to(dev), report, kernels, embs=crops)

    agg_fps = S * T / dt
    streams_at_30 = agg_fps / 30.0
    crops_per_frame = budget or S * N
    if cadence > 1:
        # the gate embeds ceil(S/k) streams' crops a frame
        crops_per_frame = min(crops_per_frame, -(-S // cadence) * N)
    crops_per_s = crops_per_frame * T / dt
    forward = cdt if cdt == "int8" else f"{cdt} " + (
        "fused" if args.fused else "folded" if cdt == "bfloat16" else "module")
    print(f"# [{label}] {card(dev)}: {agg_fps:,.0f} aggregate FPS "
          f"({crops_per_s:,.0f} crops/s through OSNet {variant} {forward}), "
          f"{dt / T * 1e3:.3f} ms/frame-batch, S={S} K={K} N={N} "
          f"crop={LIVE_HW[0]}x{LIVE_HW[1]}"
          + (f" budget={budget}" if budget else "")
          + (f" cadence={cadence}" if cadence > 1 else "")
          + f"; {_runs_line(dt, times, launches)}", file=sys.stderr,
          flush=True)
    return {
        "metric": f"{PREFIX}{tracker}_livereid"
        + ("" if variant == "x1_0" else f"_{variant}")
        + ("_int8" if cdt == "int8" else "")
        + ("_fused" if args.fused else "")
        + (f"_pb{pri_frac}" if pri_frac else (f"_cb{budget}" if budget else ""))
        + (f"_ec{cadence}" if cadence > 1 else "")
        + "_streams_at_30fps_per_chip",
        "value": round(streams_at_30, 1),
        "unit": "streams_at_30fps_per_chip",
        # the scoreboard-wide >= 256 target; the reference's images-in
        # pipeline (95 FPS, BASELINE.md) is the like-for-like ratio below
        "vs_baseline": round(streams_at_30 / 256.0, 3),
        "aggregate_fps": round(agg_fps, 1),
        "vs_ref_reid_pipeline": round(agg_fps / 95.0, 1),
    }


def legs(args) -> list:
    """The full scoreboard's fresh-process legs: (argv, label)."""
    live = ["--fused"] if args.fused else []
    out = [(["--tracker", "strongsort", "--cmc", "ecc", "--streams",
             str(CMC_STREAMS), "--metric-suffix", "_cmc_ecc"],
            "strongsort_cmc_ecc"),
           (["--tracker", "strongsort", "--livereid", "--emb-cadence", "1"]
            + live, "strongsort_livereid_bf16_everyframe")]
    out += [(["--tracker", trk, "--livereid"] + dep + live,
             f"{trk}_livereid_deployed") for trk, dep in DEPLOYED.items()]
    return out


def run_leg(extra_argv, label, args, timeout=LEG_TIMEOUT) -> dict:
    """One leg in a fresh process (``bench.py::emit_subprocess``): its row,
    or an error row ``{"metric", "error"}`` where it fails, times out or
    prints no row. Its ``#`` lines are passed on to stderr."""
    cmd = [sys.executable, "-m", "motcpp_tpu_torch.bench",
           "--frames", str(args.frames), "--repeats", str(args.repeats),
           "--lap", args.lap] + list(extra_argv)
    if args.cpu:
        cmd.append("--cpu")
    name = f"{PREFIX}{label}"
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=PACKAGE.parent)
    except subprocess.TimeoutExpired:
        print(f"# [{label}] LEG TIMED OUT after {timeout}s", file=sys.stderr,
              flush=True)
        return {"metric": name, "error": f"timeout {timeout}s"}
    for line in proc.stderr.splitlines():
        if line.startswith("#"):
            print(line, file=sys.stderr, flush=True)
    rec = None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                pass
    if proc.returncode != 0 or rec is None:
        tail = "\n".join(proc.stderr.splitlines()[-3:])
        print(f"# [{label}] LEG FAILED rc={proc.returncode}: {tail}",
              file=sys.stderr, flush=True)
        return {"metric": name, "error": f"rc={proc.returncode}: {tail[-300:]}"}
    return rec


def _build_kernels():
    """Both CUDA kernels built into ``_build/`` before any row, so that
    the fresh-process legs find them there and never build them at the
    same time."""
    from concurrent.futures import ThreadPoolExecutor

    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.ops import auction_cuda

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda b: b(), (auction_cuda.build, osblock_cuda.build)))


def _write(path: Path, rows: list, argv: list, meta: str, merge: bool):
    if merge:
        try:
            full = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            full = {"rows": [], "argv": []}
        for rec in rows:
            for i, old in enumerate(full["rows"]):
                if old.get("metric") == rec.get("metric"):
                    full["rows"][i] = rec
                    break
            else:
                full["rows"].append(rec)
    else:
        full = {"rows": rows, "argv": argv}
    full["card"] = meta
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(full, indent=1) + "\n")


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.dw_impl != "conv":
        ap.error("--dw-impl shift is not ported: the port's OSNet has one "
                 "depthwise schedule (appearance/osnet.py::depthwise3x3)")
    if args.fused and args.reid_quant:
        ap.error("--fused and --reid-quant: the int8 forward runs no OSBlock "
                 "kernel")
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = device_of(args)  # no card and no --cpu: raise before any row
    if dev.type == "cuda":
        _build_kernels()
    meta = card(dev)
    print(f"# card: {meta}; torch {torch.__version__}", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    rows = []

    def emit(rec):
        rows.append(rec)
        if "error" not in rec:
            print(json.dumps(rec), flush=True)

    try:
        if args.tracker:
            if args.livereid:
                emit(bench_livereid(args.tracker, args))
            else:
                emit(bench_one(args.tracker, args, None, args.metric_suffix))
        else:
            for trk in ALL_TRACKERS[:-1]:
                emit(bench_one(trk, args))
            if not args.quick:
                for suffix, ov in CAPACITY_ROWS:
                    for trk in CAPACITY_TRACKERS:
                        row = dict(ov)
                        if args.streams:  # an explicit -S caps them too
                            row["streams"] = min(row["streams"], args.streams)
                        emit(bench_one(trk, args, row, suffix))
                for leg_argv, label in legs(args):
                    emit(run_leg(leg_argv, label, args))
            emit(bench_one("bytetrack", args))
    finally:
        if rows and args.tracker and args.merge_full and not args.cpu:
            _write(BUILD / FULL_JSON, rows, argv, meta, merge=True)
        if rows and not args.tracker:
            # --quick and --cpu scoreboards are smoke runs: kept apart
            # from the whole scoreboard on the card
            name = QUICK_JSON if (args.quick or args.cpu) else FULL_JSON
            _write(BUILD / name, rows, argv, meta, merge=False)
    errors = [r["metric"] for r in rows if "error" in r]
    print(f"# scoreboard: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s"
          + (f"; FAILED legs: {', '.join(errors)}" if errors else ""),
          file=sys.stderr, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
