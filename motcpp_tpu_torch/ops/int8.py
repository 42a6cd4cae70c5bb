"""The int8 x int8 -> int32 matrix product of the int8 ReID path.

The JAX package computes its int8 convolutions and Dense with
``jax.lax.conv_general_dilated`` / ``dot_general`` at
``preferred_element_type=jnp.int32`` (``motcpp_tpu/appearance/quant.py``);
XLA computes those products, no Pallas kernel does. Here they are one
product, ``int8_matmul(a (M, K) int8, b (K, N) int8) -> (M, N) int32``:
on a CUDA device ``torch._int_mm`` (cuBLASLt's int8 GEMM), on the CPU
the plain version :func:`int8_matmul_reference`.

``torch._int_mm`` takes M > 16 and K and N multiples of 8 on CUDA, and
cuBLASLt refuses some layouts at small M (a row-major ``b`` at M = 17,
K = N = 64 on an H100, PyTorch 2.11), so ``b`` goes in column-major
(the layout :func:`padded_weight` gives, once for each weight) and
``a`` row-major. An operand that breaks those rules raises: nothing
switches to a float product or copies a weight to another layout.
:func:`int8_matmul_padded` pads the activations with zeros to the rules
and slices the result back, which is exact. Every sum is an integer of
at most 127^2 * K, so any correct route gives the same int32 result in
any order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: ``torch._int_mm`` launches since the last reset; ``int8_matmul`` adds
#: one per launch
LAUNCHES = 0

MIN_ROWS = 17  # torch._int_mm on CUDA: M > 16
ALIGN = 8  # torch._int_mm on CUDA: K and N multiples of 8
REFERENCE_BLOCK_BYTES = 1 << 28


def _check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) and (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes int8 operands, got {a.dtype} "
                         f"and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version, on any device: the product in float64, where
    every partial sum of int8 products is an exact integer (below 2^53),
    cast to int32; in blocks of rows, so that the float64 copies stay
    near REFERENCE_BLOCK_BYTES."""
    _check(a, b)
    M, K = a.shape
    bd = b.double()
    rows = max(1, REFERENCE_BLOCK_BYTES // (8 * (K + b.shape[1])))
    out = torch.empty((M, b.shape[1]), dtype=torch.int32, device=a.device)
    for i in range(0, M, rows):
        out[i:i + rows] = (a[i:i + rows].double() @ bd).to(torch.int32)
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b (K, N) int8 -> (M, N) int32``. CPU tensors
    take the plain version; CUDA tensors launch ``torch._int_mm`` or
    raise ValueError where M <= 16, K or N is not a multiple of 8, or
    ``b`` is not column-major (:func:`padded_weight`)."""
    global LAUNCHES
    _check(a, b)
    if a.device.type == "cpu":
        return int8_matmul_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on the CPU or a CUDA device, "
                         f"not {a.device}")
    M, K = a.shape
    N = b.shape[1]
    if M < MIN_ROWS or K % ALIGN or N % ALIGN:
        raise ValueError(
            f"torch._int_mm on CUDA takes M > 16 and K and N multiples of "
            f"{ALIGN}, got M={M}, K={K}, N={N}; pad with zeros "
            "(int8_matmul_padded)")
    if b.stride() != (1, K):
        raise ValueError(f"torch._int_mm on CUDA takes b column-major, got "
                         f"strides {b.stride()}; lay it out with "
                         "padded_weight")
    out = torch._int_mm(a.contiguous(), b)
    LAUNCHES += 1
    return out


def padded_weight(b: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 weight with K and N padded with zero rows and columns
    to multiples of 8, stored column-major (itself when it is both), so
    that a product on CUDA pads and copies only its activations."""
    K, N = b.shape
    if K % ALIGN or N % ALIGN:
        b = F.pad(b, (0, -N % ALIGN, 0, -K % ALIGN))
    if b.stride() != (1, b.shape[0]):
        b = b.t().contiguous().t()
    return b


def int8_matmul_padded(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """The (M, n) int32 product of ``a (M, K)`` and ``b (Kb, Nb)``, a
    weight whose rows past K and columns past n are zero (Kb >= K, as
    :func:`padded_weight` pads; on CUDA in its layout). ``a`` gets zero
    columns to Kb, and on CUDA zero rows to more than 16; zeros add
    nothing to a sum, so the result equals the unpadded product."""
    M, K = a.shape
    pad_m = max(MIN_ROWS - M, 0) if a.device.type == "cuda" else 0
    if b.shape[0] - K or pad_m:
        a = F.pad(a, (0, b.shape[0] - K, 0, pad_m))
    return int8_matmul(a, b)[:M, :n]
