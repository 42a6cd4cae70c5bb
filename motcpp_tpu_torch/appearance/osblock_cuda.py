"""Wrapper of the CUDA OSBlock kernel (``csrc/osblock.cu``).

The kernel replaces ``motcpp_tpu/appearance/osblock_pallas.py::
_osblock_kernel``; its plain version is ``appearance/osblock.py::
osblock_reference``. The source is built with ``nvcc`` at first use
(``cuda_build.build``) and bound through ctypes; nothing CUDA-specific
happens at import. :func:`osblock` checks its inputs, allocates the
output and the kernel's scratch with ``torch.empty``, launches on the
current stream and raises if the launch is refused. It computes nothing
else: no cuBLAS, cuDNN or PyTorch operator runs on its path.

The kernel walks each crop in tiles of whole map rows (at most 128
pixels) with one CTA per crop, as many CTAs as the SMs hold at once. In
bfloat16 its 1x1 products run on the tensor cores (``mma.sync``
m16n8k16, operands read by ``ldmatrix`` from shared memory); in float32
as float FMAs on the CUDA cores. Its copies move 16 bytes a thread, so
the channel widths must be multiples of 8 and x and the packed weights
16-byte aligned; a map row must fit one tile, and the block's tiles must
fit a CTA's shared memory. The maps between its passes go through a
per-CTA scratch in device memory. PERF.md has where its time goes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from motcpp_tpu_torch import cuda_build

SOURCE = cuda_build.CSRC / "osblock.cu"
NVCC_FLAGS = (*cuda_build.ARCH_FLAGS, "-O3", "-Xptxas", "-v",
              *cuda_build.SHARED_FLAGS)
MAX_MID = 256  # the gate is computed by one thread per channel

#: kernel launches since the last reset; ``osblock`` adds one per launch
LAUNCHES = 0

_lib = None


def build() -> Path:
    """Compile the kernel if this source and these flags have not been
    built yet; returns the shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS, "osblock")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.osblock_forward.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
        lib.osblock_forward.restype = ctypes.c_int
        lib.osblock_max_width.restype = i32
        lib.osblock_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.osblock_ctas_per_sm.argtypes = [i32, i32, i32, i32]
        lib.osblock_ctas_per_sm.restype = i32
        lib.osblock_smem_bytes.restype = ctypes.c_size_t
        lib.osblock_scratch_elems.argtypes = [i32, i32, i32]
        lib.osblock_scratch_elems.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _check(w, x):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != w.cin or x.shape[0] < 1:
        raise ValueError(f"x must be (B >= 1, H, W, {w.cin}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    if not (1 <= w.hidden and w.mid <= MAX_MID):
        raise ValueError(f"unsupported block widths mid={w.mid}, "
                         f"hidden={w.hidden}")
    if w.cin % 8 or w.mid % 8 or w.cout % 8:
        raise ValueError(f"the kernel's 16-byte copies need cin, mid and cout "
                         f"to be multiples of 8, got {w.cin}, {w.mid}, "
                         f"{w.cout}")
    if not w.has_ds and w.cin != w.cout:
        raise ValueError("a block without downsample needs cin == cout")
    for name, t, dtype in (("mats", w.mats, x.dtype),
                           ("biases", w.biases, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
    n_mats = (w.cin * w.mid + 10 * (w.mid * w.mid + 9 * w.mid)
              + 2 * w.mid * w.hidden + w.mid * w.cout
              + (w.cin * w.cout if w.has_ds else 0))
    n_biases = (11 * w.mid + w.hidden + w.mid + w.cout
                + (w.cout if w.has_ds else 0))
    if w.mats.numel() != n_mats or w.biases.numel() != n_biases:
        raise ValueError("packed weights do not match the block's widths")
    for name, t in (("x", x), ("mats", w.mats)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def osblock(w, x: torch.Tensor) -> torch.Tensor:
    """One OSBlock (``BlockWeights`` w) over NHWC x (B, H, W, cin) on a
    CUDA device -> (B, H, W, cout) in x's dtype."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the OSBlock kernel runs on CUDA tensors, x is on "
                         f"{x.device}")
    _check(w, x)
    B, H, W, _ = x.shape
    lib = _load()
    bf16 = int(x.dtype == torch.bfloat16)
    if W > lib.osblock_max_width():
        raise ValueError(f"map rows of {W} pixels exceed the kernel's tile of "
                         f"{lib.osblock_max_width()}")
    # one wave of persistent CTAs, as many as the SMs hold at once (two in
    # bfloat16 at osnet_x1_0's widths, one in float32); a scratch slot each
    with torch.cuda.device(x.device):
        per_sm = lib.osblock_ctas_per_sm(W, w.mid, w.hidden, bf16)
    if per_sm < 1:
        raise RuntimeError(
            f"the OSBlock kernel does not fit an SM (block {w.name}, W={W}, "
            f"mid={w.mid}: {lib.osblock_smem_bytes(W, w.mid, w.hidden, bf16)}"
            f" bytes of shared memory)")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(B, per_sm * sms)
    out = torch.empty((B, H, W, w.cout), dtype=x.dtype, device=x.device)
    scratch = torch.empty(grid * lib.osblock_scratch_elems(H, W, w.mid),
                          dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.osblock_forward(
            x.data_ptr(), out.data_ptr(), w.mats.data_ptr(),
            w.biases.data_ptr(), scratch.data_ptr(), B, H, W, w.cin, w.mid,
            w.cout, w.hidden, int(w.has_ds), grid, bf16, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"OSBlock kernel launch failed with CUDA error {err} "
            f"(block {w.name}, B={B}, H={H}, W={W}, cin={w.cin}, "
            f"mid={w.mid}, cout={w.cout}, "
            f"{lib.osblock_smem_bytes(W, w.mid, w.hidden, bf16)} bytes of "
            f"shared memory)"
        )
    LAUNCHES += 1
    return out
