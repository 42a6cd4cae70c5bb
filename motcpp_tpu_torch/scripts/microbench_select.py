#!/usr/bin/env python3
"""A/B microbench: the gather and scatter patterns against the
``ops/select.py`` helpers that replace them.

Counterpart of the JAX package's ``scripts/microbench_select.py``, with
its seven cases at tracker hot-path shapes (S streams x K track slots x
N detection slots, rings of R slots of D values). Each helper is timed
against the PyTorch form of the pattern the JAX package wrote before it
(``torch.gather`` for ``take_along_axis``, indexing for the vmapped row
gather, ``scatter_`` and ``index_put_`` for ``.at[...].set``), each
call alone with CUDA events (``utils/profiling.py::call_ms``), and
the two outputs are compared: every case must be exact.

The inputs are the JAX script's numpy draws, with one change: in the
matching that ``invert_matching`` inverts, a det whose track an earlier
det of its stream took is unmatched, so the matching is one to one, the
helper's domain (where the draws repeat a track, which write a scatter
keeps is unspecified on the card).

Standalone, most cases sit near the launch floor, and the comparison
says little of their cost inside a tracker's step.

Usage:
  python -m motcpp_tpu_torch.scripts.microbench_select [--streams 2048] [--k 64] [--n 32] [--repeats 50]
  python -m motcpp_tpu_torch.scripts.microbench_select --cpu --streams 8

It runs on the CUDA device and raises without one unless given
``--cpu`` (then the times are the host's, not the card's).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from motcpp_tpu_torch.utils.profiling import call_ms


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--ring", type=int, default=50)
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    return ap


def case_inputs(S, K, N, R, D, seed=0):
    """The seven cases' numpy inputs, in the JAX script's draw order."""
    rng = np.random.default_rng(seed)
    out = dict(
        mat=rng.normal(size=(S, K, N)).astype(np.float32),
        idx_kn=rng.integers(0, N, (S, K)).astype(np.int32),
        tab=rng.normal(size=(S, N, D)).astype(np.float32),
        idx_k_of_n=rng.integers(0, N, (S, K)).astype(np.int32),
        ring=rng.normal(size=(S, K, R, D)).astype(np.float32),
        slot=rng.integers(0, R, (S, K)).astype(np.int32),
        new=rng.normal(size=(S, K, D)).astype(np.float32),
        mask=rng.integers(0, 2, (S, K)).astype(bool),
    )
    d2t = np.where(rng.integers(0, 2, (S, N)).astype(bool),
                   rng.integers(0, K, (S, N)), -1).astype(np.int32)
    # one to one: a det whose track an earlier det of its stream took is
    # unmatched
    earlier = np.tril(np.ones((N, N), bool), -1)
    taken = ((d2t[:, :, None] == d2t[:, None, :]) & earlier).any(-1)
    out["d2t"] = np.where(taken, -1, d2t).astype(np.int32)
    out["rows"] = rng.integers(0, 2, (S, K)).astype(bool)
    out["cols"] = rng.integers(0, 2, (S, N)).astype(bool)
    return out


def cases(a, S, K, N, R, D):
    """[(name, gather/scatter pattern, select helper, args)] over the
    tensors ``a`` (``case_inputs`` on the device)."""
    from motcpp_tpu_torch.ops import select

    dev = a["mat"].device
    ar_s = torch.arange(S, device=dev)

    # 1. take_per_row vs take_along_axis
    def tpr_gather(m, i):
        return torch.gather(m, -1, i.long().clamp(0, N - 1)[..., None])[..., 0]

    # 2. gather_rows vs the vmapped row gather
    def gr_gather(t, i):
        return t[ar_s[:, None], i.long().clamp(0, N - 1)]

    # 3. take_slot vs take_along_axis on the ring axis
    def ts_gather(r, s):
        return r[ar_s[:, None], torch.arange(K, device=dev), s.long()]

    # 4. write_slot vs .at[].set, then the mask
    def ws_scatter(r, s, nw, m):
        flat = r.reshape(S * K, R, D).clone()
        flat[torch.arange(S * K, device=dev), s.reshape(-1).long()] = (
            nw.reshape(S * K, D))
        return torch.where(m.reshape(S * K, 1, 1), flat,
                           r.reshape(S * K, R, D)).reshape(r.shape)

    # 5. invert_matching vs the scatter that drops unmatched dets
    def im_scatter(d):
        t2d = torch.full((S, K + 1), -1, dtype=torch.int32, device=dev)
        t2d.scatter_(1, torch.where(d >= 0, d, K).long(),
                     torch.arange(N, dtype=torch.int32, device=dev)
                     .expand(S, N))
        return t2d[:, :K]

    # 6. rank_match vs the rank scatter, then the gather
    def rm_scatter(r, c):
        row_rank = torch.cumsum(r.to(torch.int32), -1) - 1
        col_rank = torch.cumsum(c.to(torch.int32), -1) - 1
        n_cols = c.sum(-1, keepdim=True)
        pos_by_rank = torch.zeros((S, K + N), dtype=torch.int32, device=dev)
        pos_by_rank.scatter_(1, torch.where(c, col_rank, K + N - 1).long(),
                             torch.arange(N, dtype=torch.int32, device=dev)
                             .expand(S, N))
        paired = r & (row_rank < n_cols)
        col = pos_by_rank.gather(1, row_rank.clamp(0, K + N - 1).long())
        return paired, torch.where(paired, col, 0)

    # 7. set_at_col vs .at[].set
    def sac_scatter(m, c):
        flat = m.reshape(S * K, N).clone()
        flat[torch.arange(S * K, device=dev), c.reshape(-1).long()] = 0.0
        return flat.reshape(m.shape)

    return [
        ("take_per_row", tpr_gather, select.take_per_row,
         (a["mat"], a["idx_kn"])),
        ("gather_rows", gr_gather, select.gather_rows,
         (a["tab"], a["idx_k_of_n"])),
        ("take_slot", ts_gather, select.take_slot, (a["ring"], a["slot"])),
        ("write_slot", ws_scatter, select.write_slot,
         (a["ring"], a["slot"], a["new"], a["mask"])),
        ("invert_matching", im_scatter,
         lambda d: select.invert_matching(d, K), (a["d2t"],)),
        ("rank_match", rm_scatter, select.rank_match, (a["rows"], a["cols"])),
        ("set_at_col", sac_scatter,
         lambda m, c: select.set_at_col(m, c, 0.0), (a["mat"], a["idx_kn"])),
    ]


def _same(x, y):
    if isinstance(x, tuple):
        return all(_same(a, b) for a, b in zip(x, y))
    return x.shape == y.shape and bool(torch.equal(x.to(y.dtype), y))


def measure(args):
    """Time and compare each case; returns {"device", "rows": [(name,
    pattern us, helper us, exact)]}."""
    from motcpp_tpu_torch.device import resolve_device

    dev = torch.device("cpu") if args.cpu else resolve_device("cuda")
    S, K, N, R, D = args.streams, args.k, args.n, args.ring, args.d
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (host times, not the card's)")
    print(f"device={where} S={S} K={K} N={N} R={R} D={D}", flush=True)
    a = {k: torch.from_numpy(v).to(dev)
         for k, v in case_inputs(S, K, N, R, D).items()}
    report = {"device": where, "rows": []}
    for name, old, new, xs in cases(a, S, K, N, R, D):
        t_old = call_ms(lambda: old(*xs), args.repeats, dev)[0] * 1e3
        t_new = call_ms(lambda: new(*xs), args.repeats, dev)[0] * 1e3
        exact = _same(new(*xs), old(*xs))
        report["rows"].append((name, t_old, t_new, exact))
        print(f"{name:18s} gather {t_old:9.1f} us   select {t_new:9.1f} us"
              f"   {t_old / t_new:5.2f}x   {'exact' if exact else 'DIFFERS'}",
              flush=True)
    return report


def main(argv=None):
    return measure(parser().parse_args(argv))


if __name__ == "__main__":
    main()
