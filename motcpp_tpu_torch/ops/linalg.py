"""Closed-form inverses of tiny matrices for the Kalman filter.

Counterpart of ``motcpp_tpu/ops/linalg.py``. The adjugate inverses and
the unrolled products keep the JAX package's operation order, so the
port's Kalman algebra follows the reference's rounding rather than that
of a general LU solve. All functions take ``(..., n, n)`` and broadcast
over leading dimensions.
"""

from __future__ import annotations

import torch


def inv2(M):
    """(..., 2, 2) inverse and determinant."""
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 0]
    d = M[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack(
        [torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2
    ) / det[..., None, None]
    return inv, det


def inv3(M):
    """(..., 3, 3) inverse via the adjugate."""
    m = [[M[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
    c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    c10 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
    c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
    c12 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
    c20 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
    c21 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
    c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], -1),
            torch.stack([c01, c11, c21], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def inv4(M):
    """(..., 4, 4) inverse via cofactor expansion."""
    m = [[M[..., i, j] for j in range(4)] for i in range(4)]

    def det3(a, b, c, d, e, f, g, h, i):
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)

    idx = (0, 1, 2, 3)
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = [r for r in idx if r != i]
        for j in range(4):
            cj = [c for c in idx if c != j]
            s = 1.0 if (i + j) % 2 == 0 else -1.0
            cof[i][j] = s * det3(
                m[ri[0]][cj[0]], m[ri[0]][cj[1]], m[ri[0]][cj[2]],
                m[ri[1]][cj[0]], m[ri[1]][cj[1]], m[ri[1]][cj[2]],
                m[ri[2]][cj[0]], m[ri[2]][cj[1]], m[ri[2]][cj[2]],
            )
    det = sum(m[0][j] * cof[0][j] for j in range(4))
    # adjugate = transpose of the cofactor matrix
    adj = torch.stack(
        [torch.stack([cof[j][i] for j in range(4)], -1) for i in range(4)], -2
    )
    return adj / det[..., None, None]


def inv5(M):
    """(..., 5, 5) inverse via the Schur complement of the 4x4 corner:
    M = [[A (4x4), b (4x1)], [c (1x4), d (1x1)]]."""
    A = M[..., :4, :4]
    b = M[..., :4, 4:5]
    c = M[..., 4:5, :4]
    d = M[..., 4:5, 4:5]
    Ai = inv4(A)
    Aib = matmul_small(Ai, b)  # (..., 4, 1)
    cAi = matmul_small(c, Ai)  # (..., 1, 4)
    s = d - matmul_small(c, Aib)  # (..., 1, 1) Schur complement
    si = 1.0 / s
    tl = Ai + matmul_small(Aib, si * cAi)
    tr = -Aib * si
    bl = -si * cAi
    top = torch.cat([tl, tr], dim=-1)
    bot = torch.cat([bl, si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def matmul_small(A, B):
    """(..., m, n) @ (..., n, p) for n <= 8 as n rank-1 updates, summed
    in index order (the JAX package's order); larger n uses ``@``."""
    n = A.shape[-1]
    if n > 8:
        return A @ B
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for a in range(1, n):
        out = out + A[..., :, a:a + 1] * B[..., a:a + 1, :]
    return out


def solve_spd(S, B):
    """Solve S X = B for a tiny SPD ``S (..., n, n)``, 2 <= n <= 5, and
    ``B (..., n, k)`` with the closed-form inverse."""
    n = S.shape[-1]
    if n == 2:
        Si, _ = inv2(S)
    elif n == 3:
        Si = inv3(S)
    elif n == 4:
        Si = inv4(S)
    elif n == 5:
        Si = inv5(S)
    else:
        raise ValueError(f"solve_spd takes 2 <= n <= 5, got n={n}")
    return matmul_small(Si, B)
