#!/usr/bin/env python3
"""Per-piece OSNet timing on the card: where the crops/s go.

Counterpart of the JAX package's ``scripts/profile_osnet.py``. The
live-ReID paths run osnet_x1_0 in bf16 over 2048-crop batches (S=128
streams x N=16 crops). This script times the whole forward, then each
sequential piece standalone at the path's shapes and dtype, each beside
the least time the card could take for it:

  * the module forward (``appearance/osnet.py::OSNet``, NCHW, cuDNN
    convolutions) and its pieces: conv1 7x7/2, the max pool, the six
    OSBlocks, the two transitions (1x1 conv and 2x2 average pool), conv5
    with its mean and the ``fc`` head;
  * with ``--fused``, the fused forward (``appearance/osblock.py::
    forward_fused``, NHWC, BN folded) and its pieces
    (``osblock.fused_pieces``): each OSBlock through the OSBlock CUDA
    kernel beside its plain version ``osblock_reference``, and conv1, the
    transitions and conv5 through ``appearance/quant.py::_conv``, whose
    products run in float32 also under bf16 (no tensor cores); the bound
    stays the bf16 one. Each kernel block's cosine to its plain version
    on the same input says the kernel is not fast and wrong.
  * with ``--fused``, the precision over 64 crops: the per-crop cosine,
    min and mean, of the fused to the module forward in the profiled
    dtype and in float32 (TF32 off), and of each forward in the profiled
    dtype to the float32 one; then each piece alone on the input the
    float32 chain gives it, both paths' pieces in the profiled dtype
    against the float32 piece and against each other, beside how far
    the module chain in that dtype has drifted there. At the seeded
    random weights the bf16 forwards drift from float32 through depth
    (about 1% a piece, amplified stage by stage: the JAX package's bf16
    forward drifts as far on the same weights) while each piece alone
    stays within bf16 rounding.

Each piece is timed on the input the chain gives it (one seeded normal
batch through the pieces in order) with CUDA events
(``utils/profiling.py::call_ms``). Its operations and bytes are
counted from the shapes (each input and output once, weights once; two
operations a multiply-add); the bound is the larger of bytes at
``--peak-gbps`` and operations at ``--peak-tflops`` (bf16) or the
float32 rate, the H100's published rates by default. ``--roofline``
adds the whole forward's count. A row whose one call took the host as
long to launch as the card to run is marked: the host may set its time.

Usage:
  python -m motcpp_tpu_torch.scripts.profile_osnet [--batch 2048] [--dtype bfloat16] [--fused] [--roofline]
  python -m motcpp_tpu_torch.scripts.profile_osnet --cpu --batch 4 --hw 64 32 --fused

It runs on the CUDA device and raises without one unless given
``--cpu`` (then the times are the host's, not the card's).
"""

from __future__ import annotations

import argparse
import copy

import torch

from motcpp_tpu_torch.utils.profiling import (
    BF16_OPS_PER_S,
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    bound_ms,
    call_ms,
    crop_cosine,
    exact_float32,
    osblock_cost,
    uncounted,
)

BLOCKS = ("conv2_0", "conv2_1", "conv3_0", "conv3_1", "conv4_0", "conv4_1")
COSINE_CROPS = 64


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 128))
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--fused", action="store_true",
                    help="also the fused forward, every OSBlock through "
                    "the OSBlock CUDA kernel (csrc/osblock.cu), beside "
                    "the module forward at the same batch and dtype")
    ap.add_argument("--roofline", action="store_true",
                    help="the whole forward's operations and bytes, "
                    "counted from the shapes, against the compute and "
                    "HBM rooflines")
    ap.add_argument("--peak-tflops", type=float, default=BF16_OPS_PER_S / 1e12,
                    help="peak bf16 TFLOP/s (H100 SXM default; float32 "
                    "pieces use the float32 CUDA-core rate, "
                    f"{FP32_OPS_PER_S / 1e12:g})")
    ap.add_argument("--peak-gbps", type=float, default=HBM_BYTES_PER_S / 1e9,
                    help="peak HBM GB/s (H100 SXM default)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    return ap


def _nhwc(t, nchw):
    """(B, H, W, C) of an activation in either layout ((B, C) for 2-D)."""
    if t.dim() == 2:
        return t.shape[0], 1, 1, t.shape[1]
    if nchw:
        B, C, H, W = t.shape
        return B, H, W, C
    return tuple(t.shape)


def piece_cost(name, x, y, folded, packed, dtype, nchw=False):
    """(operations, bytes) of piece ``name`` taking x to y: each input
    and output once (in the path's dtype; conv5's mean and the head are
    float32), weights once, two operations a multiply-add, one a pooling
    comparison or add."""
    elem = 2 if dtype == torch.bfloat16 else 4
    B, H, W, C = _nhwc(x, nchw)
    _, Ho, Wo, Co = _nhwc(y, nchw)
    n_in, n_out = B * H * W * C, B * Ho * Wo * Co
    if name in BLOCKS:
        return osblock_cost(packed[name], B, H, W, dtype)
    if name == "maxpool":
        return 8 * n_out, (n_in + n_out) * elem
    leaf = folded[name]
    k = leaf["kernel"]
    weights = k.numel() * elem + leaf["bias"].numel() * 4
    if name == "conv1":
        kh, kw, cin, cout = k.shape
        return 2 * n_out * kh * kw * cin, (n_in + n_out) * elem + weights
    if name == "fc_0":
        return 2 * B * C * Co, (n_in + n_out + k.numel() + Co) * 4
    # a 1x1 conv over the input, then the 2x2 average pool or the mean
    ops = 2 * n_in * Co + n_in
    out_elem = 4 if name == "conv5" else elem
    return ops, n_in * elem + n_out * out_elem + weights


def _model_pieces(m):
    """The module forward's pieces in order, NCHW (as ``OSNet.forward``
    runs them after its permute)."""
    return [
        ("conv1", m.conv1), ("maxpool", m.maxpool),
        ("conv2_0", m.conv2[0]), ("conv2_1", m.conv2[1]),
        ("conv2_2_0", m.conv2[2]),
        ("conv3_0", m.conv3[0]), ("conv3_1", m.conv3[1]),
        ("conv3_2_0", m.conv3[2]),
        ("conv4_0", m.conv4[0]), ("conv4_1", m.conv4[1]),
        ("conv5", lambda v: m.conv5(v).mean(dim=(2, 3))),
        ("fc_0", m.fc),
    ]


def chain_inputs(pieces, x):
    """Run the pieces in order from x; returns each piece's (input,
    output) and the last output."""
    io = []
    for _, fn in pieces:
        y = fn(x)
        io.append((x, y))
        x = y
    return io, x


def _to_nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def _min_mean(cos):
    return float(cos.min()), float(cos.mean())


def precision(model, module, folded, packed, x):
    """How far the two forwards in x's dtype are from float32 (TF32 off)
    and from each other, on the crops x (B, H, W, 3); their kernel
    launches are :func:`uncounted`. Returns {"cosine": per-crop cosine
    (min, mean) of the fused to the module forward, "cosine_f32": the
    same in float32, "cosine_to_f32": {"module", "fused"}: each forward's
    to the float32 module forward, "pieces_precision": for each piece, on
    the input the float32 module chain gives it, the min cosine of the
    module piece ("module") and of the fused piece ("fused") to the
    float32 module piece and of the two to each other ("fused_module"),
    and the min cosine of the module chain's output there to the float32
    chain's ("chain")}. ``model`` is the float32 OSNet, ``module`` it in
    x's dtype, ``folded`` and ``packed`` the fused forward's tree and
    blocks in that dtype."""
    from motcpp_tpu_torch.appearance import osblock
    from motcpp_tpu_torch.appearance.quant import fold_osnet

    dev = x.device
    with exact_float32(), uncounted():
        model32 = copy.deepcopy(model).to(dev).eval()
        tree32 = {k: {kk: v.to(dev) for kk, v in leaf.items()}
                  for k, leaf in fold_osnet(model).items()}
        xf = x.float()
        m32, f32 = model32(xf), osblock.forward_fused(tree32, xf)
        m16, f16 = module(x), osblock.forward_fused(folded, x, packed)
        report = {"cosine": _min_mean(crop_cosine(f16, m16)),
                  "cosine_f32": _min_mean(crop_cosine(f32, m32)),
                  "cosine_to_f32": {
                      "module": _min_mean(crop_cosine(m16, m32)),
                      "fused": _min_mean(crop_cosine(f16, m32))}}
        del m32, f32, m16, f16
        fused = osblock.fused_pieces(folded, packed)
        io32, _ = chain_inputs(_model_pieces(model32), xf.permute(0, 3, 1, 2))
        io_m, _ = chain_inputs(_model_pieces(module), x.permute(0, 3, 1, 2))
        io_f, _ = chain_inputs(fused, x)
        rows = []
        for (name, piece_m), (_, piece_f), (xi, y32), (_, ym_chain), (
                xf_i, _) in zip(_model_pieces(module), fused, io32, io_m,
                                io_f):
            ym = _to_nhwc(piece_m(xi.to(x.dtype)))
            yf = piece_f(_to_nhwc(xi).to(xf_i.dtype))
            y32 = _to_nhwc(y32)
            rows.append({
                "name": name,
                "module": float(crop_cosine(ym, y32).min()),
                "fused": float(crop_cosine(yf, y32).min()),
                "fused_module": float(crop_cosine(yf, ym).min()),
                "chain": float(crop_cosine(_to_nhwc(ym_chain), y32).min())})
        del io32, io_m, io_f
    report["pieces_precision"] = rows
    return report


def print_precision(report, dtype):
    n_m, n_f = report["cosine_to_f32"]["module"], report["cosine_to_f32"][
        "fused"]
    print(f"  per-crop cosine, min and mean: fused to module forward "
          f"{dtype} {report['cosine'][0]:.5f} {report['cosine'][1]:.5f}, "
          f"float32 (TF32 off) {report['cosine_f32'][0]:.7f} "
          f"{report['cosine_f32'][1]:.7f}; to the float32 module forward: "
          f"{dtype} module {n_m[0]:.5f} {n_m[1]:.5f}, {dtype} fused "
          f"{n_f[0]:.5f} {n_f[1]:.5f}", flush=True)
    print(f"  each piece alone on the float32 chain's input, min per-crop "
          f"cosine in {dtype}: module and fused piece to the float32 piece, "
          f"fused to module; then the {dtype} module chain's output to the "
          f"float32 chain's", flush=True)
    for r in report["pieces_precision"]:
        print(f"    {r['name']:10s} module {r['module']:.6f} fused "
              f"{r['fused']:.6f} fused-module {r['fused_module']:.6f}  "
              f"chain {r['chain']:.5f}", flush=True)


def _label(name, x, y, nchw):
    B, H, W, C = _nhwc(x, nchw)
    _, Ho, Wo, Co = _nhwc(y, nchw)
    if y.dim() == 2:
        return f"{name} ({C}->{Co})"
    return f"{name} ({C}->{Co}, {H}x{W}->{Ho}x{Wo})"


def profile(args):
    """Time the forwards and their pieces, printing each row as it is
    measured; returns the report (times in ms, counts from the
    shapes)."""
    from motcpp_tpu_torch.appearance import osblock, osnet
    from motcpp_tpu_torch.appearance.quant import fold_osnet
    from motcpp_tpu_torch.device import resolve_device

    dev = torch.device("cpu") if args.cpu else resolve_device("cuda")
    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    B, (H, W) = args.batch, args.hw
    peak_ops = (args.peak_tflops * 1e12 if dt == torch.bfloat16
                else FP32_OPS_PER_S)
    bw = args.peak_gbps * 1e9

    model = osnet.init_params(osnet.osnet_x1_0(), seed=0)
    module = copy.deepcopy(model).to(dev, dt).eval()
    folded = {n: {k: v.to(dev, dt) for k, v in leaf.items()}
              for n, leaf in fold_osnet(model).items()}
    packed = osblock.pack_blocks(folded, dt)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, H, W, 3), generator=gen, device=dev).to(dt)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (host times, not the card's)")
    report = {"device": where, "batch": B, "hw": (H, W),
              "dtype": args.dtype}

    def timed(fn, reps):
        return call_ms(fn, reps, dev)

    def rows_of(path, pieces, x_in, nchw, full_ms):
        with uncounted():  # the pieces' inputs
            io, _ = chain_inputs(pieces, x_in)
        rows = []
        for (name, fn), (xi, yo) in zip(pieces, io):
            ms, host_ms = timed(lambda: fn(xi), args.repeats)
            ops, nbytes = piece_cost(name, xi, yo, folded, packed, dt, nchw)
            peak = FP32_OPS_PER_S if name == "maxpool" else peak_ops
            b_ms, by = bound_ms(ops, nbytes, peak, bw)
            row = {"path": path, "name": name,
                   "label": _label(name, xi, yo, nchw), "ms": ms,
                   "host_ms": host_ms, "ops": ops, "bytes": nbytes,
                   "bound_ms": b_ms, "bound_by": by}
            notes = []
            if name in BLOCKS and path == "fused":
                w = packed[name]

                def plain():
                    return osblock.osblock_reference(w.folded, w.name, xi,
                                                     w.cout)

                row["plain_ms"] = timed(plain, 1)[0]
                ref = plain()
                row["cosine"] = float(crop_cosine(yo, ref).min())
                row["max_abs_err"] = float((yo.float() - ref.float()).abs()
                                           .max())
                del ref
                notes.append(f"plain {row['plain_ms']:.3f} ms, min cosine "
                             f"to it {row['cosine']:.6f}, max abs err "
                             f"{row['max_abs_err']:.4g}")
            elif path == "fused" and dt == torch.bfloat16 and name not in (
                    "maxpool", "fc_0"):
                notes.append("float32 products (quant._conv)")
            if dev.type == "cuda" and host_ms >= 0.5 * ms:
                notes.append(f"host may set this time: one launch took "
                             f"{host_ms:.3f} ms")
            rows.append(row)
            print(f"  {path:6s} {row['label']:38s} {ms:9.3f} ms "
                  f"{100 * ms / full_ms:5.1f}% of the forward "
                  f"{ops / 1e9:9.3f} GFLOP {nbytes / 1e6:9.1f} MB  bound "
                  f"{b_ms:.4g} ms ({by}) x{ms / b_ms:.1f}"
                  + (f"  [{'; '.join(notes)}]" if notes else ""), flush=True)
        return rows

    with torch.inference_mode():
        full_ms, _ = timed(lambda: module(x), args.repeats)
        report["full_ms"] = full_ms
        print(f"module osnet_x1_0 {args.dtype} B={B} {H}x{W} on "
              f"{where}: {full_ms:.3f} ms ({B / full_ms * 1e3:,.0f} crops/s)",
              flush=True)
        if args.fused:
            fused_ms, _ = timed(
                lambda: osblock.forward_fused(folded, x, packed),
                args.repeats)
            report["fused_ms"] = fused_ms
            print(f"fused osnet_x1_0 {args.dtype} B={B}: "
                  f"{fused_ms:.3f} ms ({B / fused_ms * 1e3:,.0f} crops/s), "
                  f"{full_ms / fused_ms:.2f}x the module forward", flush=True)
            report.update(precision(
                model, module, folded, packed, x[:min(COSINE_CROPS, B)]))
            print_precision(report, args.dtype)

        print("pieces, each alone on the input the chain gives it:")
        module_rows = rows_of("module", _model_pieces(module),
                              x.permute(0, 3, 1, 2), True, full_ms)
        report["module_rows"] = module_rows
        total = sum(r["ms"] for r in module_rows)
        print(f"  sum of the module's pieces {total:.3f} ms = "
              f"{100 * total / full_ms:.1f}% of its forward", flush=True)
        if args.fused:
            fused_rows = rows_of("fused", osblock.fused_pieces(
                folded, packed), x, False, report["fused_ms"])
            report["fused_rows"] = fused_rows
            total = sum(r["ms"] for r in fused_rows)
            blocks = sum(r["ms"] for r in fused_rows if r["name"] in BLOCKS)
            print(f"  sum of the fused pieces {total:.3f} ms = "
                  f"{100 * total / report['fused_ms']:.1f}% of the fused "
                  f"forward; the six OSBlock kernel rows {blocks:.3f} ms, the "
                  f"rest {total - blocks:.3f} ms", flush=True)

    if args.roofline:
        rows = report.get("fused_rows", report["module_rows"])
        ops = sum(r["ops"] for r in rows)
        layered = sum(r["bytes"] for r in rows)
        elem = 2 if dt == torch.bfloat16 else 4
        weights = sum(v.numel() * v.element_size()
                      for leaf in folded.values() for v in leaf.values())
        once = x.numel() * elem + weights + B * model.feature_dim * 4
        t_ops = ops / peak_ops * 1e3
        roof = {"ops": ops, "bytes": once, "layered_bytes": layered,
                "ops_ms": t_ops, "bytes_ms": once / bw * 1e3,
                "layered_ms": layered / bw * 1e3}
        report["roofline"] = roof
        sol, bound = max((t_ops, "compute"), (roof["bytes_ms"], "bandwidth"))
        print(f"roofline (counted from the shapes): {ops / B / 1e9:.3f} "
              f"GFLOP/crop; {once / B / 1e6:.3f} MB/crop for the input, "
              f"weights and output once, {layered / B / 1e6:.2f} MB/crop with "
              f"every piece's input and output through HBM")
        print(f"  compute {t_ops:.3f} ms | bandwidth "
              f"{roof['bytes_ms']:.3f} ms (layer by layer "
              f"{roof['layered_ms']:.3f} ms) -> binding: {bound} "
              f"({args.peak_tflops:g} TFLOP/s, {args.peak_gbps:g} GB/s)")
        for label, ms in (("module", full_ms),
                          ("fused", report.get("fused_ms"))):
            if ms is not None:
                print(f"  {label} forward {ms:.3f} ms = {100 * sol / ms:.2f}% "
                      f"of the {bound} speed of light")
    return report


def main(argv=None):
    return profile(parser().parse_args(argv))


if __name__ == "__main__":
    main()
