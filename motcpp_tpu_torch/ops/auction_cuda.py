"""Wrapper of the CUDA auction kernel (``csrc/auction.cu``).

The kernel replaces ``motcpp_tpu/ops/auction_pallas.py::_auction_kernel``;
its plain version is ``ops/auction.py::solve_lap_auction``. The source
is built with ``nvcc`` into a shared library at first use
(``cuda_build.build``: under ``motcpp_tpu_torch/_build/``, keyed on a
hash of the source and the flags) and bound through ctypes. Nothing
CUDA-specific happens at import.

``solve`` takes the plain version for tensors on the CPU only. For
tensors on a CUDA device it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from motcpp_tpu_torch import cuda_build
from motcpp_tpu_torch.ops import auction

SOURCE = cuda_build.CSRC / "auction.cu"
NVCC_FLAGS = (*cuda_build.ARCH_FLAGS, "-O3", "-fmad=false", "-Xptxas", "-v",
              *cuda_build.SHARED_FLAGS)
MAX_K = 256
MAX_N = 128

#: kernel launches since the last reset; ``solve`` adds one per launch
LAUNCHES = 0

_lib = None


def build() -> Path:
    """Compile the kernel if this source and these flags have not been
    built yet; returns the shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS, "auction")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr = ctypes.c_void_p
        lib.auction_solve.argtypes = [
            ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ptr, ptr, ptr,
        ]
        lib.auction_solve.restype = ctypes.c_int
        lib.auction_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.auction_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _check(cost, row_mask, col_mask, thresh):
    if cost.dim() != 3:
        raise ValueError(f"cost must be (P, K, N), got {tuple(cost.shape)}")
    P, K, N = cost.shape
    if not (1 <= K <= MAX_K and 1 <= N <= MAX_N):
        raise ValueError(
            f"the auction kernel takes 1 <= K <= {MAX_K} and "
            f"1 <= N <= {MAX_N}, got K={K}, N={N}"
        )
    want = {"cost": (cost, torch.float32, (P, K, N)),
            "row_mask": (row_mask, torch.bool, (P, K)),
            "col_mask": (col_mask, torch.bool, (P, N)),
            "thresh": (thresh, torch.float32, (P,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != cost.device:
            raise ValueError(f"{name} is on {t.device}, cost on {cost.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} of shape {shape}, got "
                f"{t.dtype} of shape {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def solve(cost: torch.Tensor, row_mask: torch.Tensor, col_mask: torch.Tensor,
          thresh: torch.Tensor):
    """Masked, cost-limited assignment of P problems: (P, K, N) float32
    cost, (P, K) and (P, N) bool masks, (P,) float32 thresholds ->
    (P, K) row2col and (P, N) col2row, int32, -1 for unmatched."""
    global LAUNCHES
    _check(cost, row_mask, col_mask, thresh)
    if cost.device.type == "cpu":
        return auction.solve_lap_auction(cost, row_mask, col_mask, thresh)
    if cost.device.type != "cuda":
        raise ValueError(f"no auction kernel for device {cost.device}")
    P, K, N = cost.shape
    row2col = torch.empty((P, K), dtype=torch.int32, device=cost.device)
    col2row = torch.empty((P, N), dtype=torch.int32, device=cost.device)
    lib = _load()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.auction_solve(
            cost.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(),
            thresh.data_ptr(), P, K, N, auction.EPS_FRAC, auction.MAX_ROUNDS,
            row2col.data_ptr(), col2row.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"auction kernel launch failed with CUDA error {err} "
            f"(P={P}, K={K}, N={N}, "
            f"{lib.auction_smem_bytes(K, N)} bytes of shared memory)"
        )
    LAUNCHES += 1
    return row2col, col2row
