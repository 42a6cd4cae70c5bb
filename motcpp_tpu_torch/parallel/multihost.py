"""Two-process stream-parallel dryrun over ``torch.distributed``.

Counterpart of ``scripts/dryrun_multihost.py`` and
``__graft_entry__.py::dryrun_multihost``: N worker processes on
localhost join one process group (the ``gloo`` backend over a TCP
store), each runs its own streams of one deterministic scene through a
sharded MultiStreamRunner (DEVICES_PER_PROC shards of
STREAMS_PER_DEVICE streams, all on its one ``device``), and the
per-stream emission counts are gathered over the group. Every rank must
hold the counts of a one-process run of the whole scene, or the run
fails. Streams never communicate: only the counts cross processes, as
CPU tensors, so the ``gloo`` backend serves both the CPU and the card
(two ranks cannot share one GPU under NCCL).

    python -m motcpp_tpu_torch.parallel.multihost [--procs 2] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

DEVICES_PER_PROC = 4
STREAMS_PER_DEVICE = 2
T, N, K = 3, 4, 8
TIMEOUT = 300.0  # seconds the workers may take, all together


def _scene(S):
    """The deterministic scene of every stream: each process builds it on
    the host (a few kB) and hands its runner only its own streams."""
    import numpy as np

    rng = np.random.default_rng(0)
    dets = rng.uniform(0, 100, (T, S, N, 6)).astype(np.float32)
    dets[..., 2:4] += 120.0
    dets[..., 4] = 0.9
    dets[..., 5] = 0.0
    masks = np.ones((T, S, N), bool)
    return dets, masks


def _bytetrack(device):
    """ByteTrack through the auction kernel: launched on the card, its
    plain version on CPU tensors."""
    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )

    return make_bytetrack(ByteTrackConfig(max_tracks=K, max_dets=N,
                                          lap_impl="auction_pallas"),
                          device=device)


def one_process_counts(S, device):
    """Per-stream emissions of one process running the whole scene on one
    device."""
    import torch

    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    init_fn, step_fn = _bytetrack(device)
    _, out_masks = MultiStreamRunner(init_fn, step_fn, S,
                                     device=device).run(*_scene(S))
    return out_masks.sum((0, 2), dtype=torch.int32).cpu()


def worker(rank: int, n_procs: int, port: int, device: str) -> int:
    import torch
    import torch.distributed as dist

    from motcpp_tpu_torch.parallel.collectives import (
        Mesh,
        emission_stats,
        per_stream_emissions,
    )
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    mesh = Mesh([device] * DEVICES_PER_PROC)  # raises before joining
    if device == "cpu":
        torch.set_num_threads(1)  # a scene of a few kB
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n_procs, rank=rank)
    try:
        S = n_procs * DEVICES_PER_PROC * STREAMS_PER_DEVICE
        local = S // n_procs
        dets, masks = _scene(S)
        mine = slice(rank * local, (rank + 1) * local)
        init_fn, step_fn = _bytetrack(device)
        runner = MultiStreamRunner(init_fn, step_fn, local, devices=mesh)
        _, out_masks = runner.run(dets[:, mine], masks[:, mine])
        counts = per_stream_emissions(out_masks, mesh).cpu()
        gathered = [torch.empty_like(counts) for _ in range(n_procs)]
        dist.all_gather(gathered, counts)
        got = torch.cat(gathered)
        want = one_process_counts(S, device)
        ok = torch.equal(got, want)
        stats = emission_stats(out_masks, mesh)
        print(json.dumps({
            "rank": rank, "ok": ok, "processes": n_procs,
            "devices_per_process": DEVICES_PER_PROC, "streams": S,
            "device": str(mesh[0]), "emissions": int(got.sum()),
            "local_emissions": stats["total_emissions"],
            "counts": got.tolist()}), flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A localhost TCP port that was free a moment ago (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multihost(n_processes: int = 2, device="cuda",
                     port=None) -> dict:
    """Spawn ``n_processes`` workers, one rank each of a ``gloo`` group on
    localhost (at ``port``, or a free one), each running its streams on
    ``device`` (default "cuda", raising where there is none; "cpu" runs on
    the CPU) through the auction kernel; returns rank 0's report (streams,
    emissions, per-stream counts) and the wall time, or raises
    RuntimeError if a worker failed, disagreed with the one-process run or
    outlived ``TIMEOUT`` seconds."""
    from motcpp_tpu_torch.device import resolve_device

    resolve_device(device)  # raises before any worker starts
    port = free_port() if port is None else int(port)
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "motcpp_tpu_torch.parallel.multihost",
         "--worker", str(rank), "--procs", str(n_processes), "--port",
         str(port), "--device", str(device)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(n_processes)]
    outs = []
    try:
        for p in procs:
            left = max(1.0, TIMEOUT - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dryrun_multihost: a worker outlived "
                           f"{TIMEOUT} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = out.strip().splitlines()
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dryrun_multihost: rank {rank} exited "
                               f"{p.returncode}:\n{out}\n{err[-4000:]}")
        reports.append(json.loads(lines[-1]))
    if not all(r["ok"] for r in reports) or any(
            r["counts"] != reports[0]["counts"] for r in reports):
        raise RuntimeError(f"dryrun_multihost: ranks disagree: {reports}")
    return dict(reports[0], seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if args.worker is not None:
        return worker(args.worker, args.procs, args.port, device)
    report = dryrun_multihost(args.procs, device, args.port)
    print(f"dryrun_multihost OK: {report['processes']} processes x "
          f"{report['devices_per_process']} shards on {report['device']}, "
          f"S={report['streams']} streams, {report['emissions']} emissions, "
          f"per-stream counts equal to one process "
          f"({report['seconds']:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
