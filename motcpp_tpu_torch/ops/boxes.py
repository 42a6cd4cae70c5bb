"""Bounding-box format conversions on ``(..., 4)`` tensors.

Counterpart of ``motcpp_tpu/ops/boxes.py``, with the same arithmetic in
the same order. Formats:

  * ``xyxy``: (x1, y1, x2, y2) corner boxes
  * ``xywh``: (cx, cy, w, h) center boxes
  * ``tlwh``: (top-left-x, top-left-y, w, h)
  * ``xyah``: (cx, cy, aspect=w/h, h)   — ByteTrack/StrongSORT KF space
  * ``xysr``: (cx, cy, scale=w*h, ratio=w/h) — SORT/OC-SORT KF space
"""

from __future__ import annotations

import torch


def _stack(*cols):
    return torch.stack(cols, dim=-1)


def _safe_ratio(num, den, floor):
    """num / den where den > floor, else 0 (the reference's guard)."""
    ok = den > floor
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def xyxy2xywh(xyxy: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = xyxy.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return _stack(x1 + 0.5 * w, y1 + 0.5 * h, w, h)


def xywh2xyxy(xywh: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = xywh.unbind(-1)
    hw = 0.5 * w
    hh = 0.5 * h
    return _stack(xc - hw, yc - hh, xc + hw, yc + hh)


def xywh2tlwh(xywh: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = xywh.unbind(-1)
    return _stack(xc - 0.5 * w, yc - 0.5 * h, w, h)


def tlwh2xywh(tlwh: torch.Tensor) -> torch.Tensor:
    t, l, w, h = tlwh.unbind(-1)
    return _stack(t + 0.5 * w, l + 0.5 * h, w, h)


def tlwh2xyxy(tlwh: torch.Tensor) -> torch.Tensor:
    t, l, w, h = tlwh.unbind(-1)
    return _stack(t, l, t + w, l + h)


def xyxy2tlwh(xyxy: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = xyxy.unbind(-1)
    return _stack(x1, y1, x2 - x1, y2 - y1)


def tlwh2xyah(tlwh: torch.Tensor) -> torch.Tensor:
    """Aspect a = w/h, 0 where h <= 0 (reference: utils/ops.hpp:79-85)."""
    t, l, w, h = tlwh.unbind(-1)
    return _stack(t + 0.5 * w, l + 0.5 * h, _safe_ratio(w, h, 0.0), h)


def xyah2tlwh(xyah: torch.Tensor) -> torch.Tensor:
    xc, yc, a, h = xyah.unbind(-1)
    w = a * h
    return _stack(xc - 0.5 * w, yc - 0.5 * h, w, h)


def xywh2xyah(xywh: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = xywh.unbind(-1)
    return _stack(xc, yc, _safe_ratio(w, h, 0.0), h)


def xyah2xywh(xyah: torch.Tensor) -> torch.Tensor:
    xc, yc, a, h = xyah.unbind(-1)
    return _stack(xc, yc, a * h, h)


def xyxy2xyah(xyxy: torch.Tensor) -> torch.Tensor:
    return tlwh2xyah(xyxy2tlwh(xyxy))


def xyah2xyxy(xyah: torch.Tensor) -> torch.Tensor:
    return tlwh2xyxy(xyah2tlwh(xyah))


def xyxy2xysr(xyxy: torch.Tensor) -> torch.Tensor:
    """(x1,y1,x2,y2) -> (cx, cy, s=w*h, r=w/h); r is 0 where h <= 1e-6
    (reference: utils/ops.hpp:188-197)."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return _stack(x1 + 0.5 * w, y1 + 0.5 * h, w * h, _safe_ratio(w, h, 1e-6))


def xysr2xyxy(xysr: torch.Tensor) -> torch.Tensor:
    """(cx, cy, s, r) -> (x1,y1,x2,y2) with w = sqrt(s*r), h = s/w; a
    negative s*r gives NaN, as in the reference (utils/ops.hpp:202-211)."""
    xc, yc, s, r = xysr.unbind(-1)
    w = torch.sqrt(s * r)
    h = s / torch.where(w != 0.0, w, torch.full_like(w, 1e-12))
    hw = 0.5 * w
    hh = 0.5 * h
    return _stack(xc - hw, yc - hh, xc + hw, yc + hh)


def warp_corners(xyxy: torch.Tensor, warp: torch.Tensor):
    """Both corners of (S, K, 4) boxes through the per-stream (S, 2, 3)
    camera-motion affines: the warped (x1, y1) and (x2, y2), each
    (S, K, 2)."""
    ones = torch.ones_like(xyxy[..., :1])
    wt = warp.transpose(-1, -2)[:, None]  # (S, 1, 3, 2)

    def apply(xy):
        return torch.matmul(torch.cat([xy, ones], -1)[..., None, :],
                            wt)[..., 0, :]

    return apply(xyxy[..., 0:2]), apply(xyxy[..., 2:4])
