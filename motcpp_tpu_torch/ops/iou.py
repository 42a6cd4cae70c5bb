"""Pairwise IoU-family similarities as ``(..., N, M)`` broadcasts.

Counterpart of ``motcpp_tpu/ops/iou.py``, with the same arithmetic in
the same order. Every function takes ``boxes1 (..., N, 4)`` and
``boxes2 (..., M, 4)`` in xyxy (oriented boxes: ``(..., 5)`` rows of
[cx, cy, w, h, angle]) and returns ``(..., N, M)``; padded rows and
columns give values that the callers' masks ignore. Conventions, as in
the reference (utils/iou.hpp:63-412):

  * ``iou``: plain IoU in [0, 1]; ``hmiou``: IoU times the vertical
    overlap ratio;
  * ``giou`` / ``diou`` / ``ciou``: rescaled from [-1, 1] to [0, 1];
  * ``centroid``: 1 - normalised centre distance;
  * ``iou_obb``: exact rotated IoU by a fixed-capacity
    Sutherland-Hodgman clip (the reference calls
    cv::rotatedRectangleIntersection).
"""

from __future__ import annotations

import math

import torch


def _areas(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _where0(cond, num, den):
    """num / den where cond, else 0, without dividing by a masked den."""
    return torch.where(cond, num / torch.where(cond, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def iou_batch(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes ``(..., N, 4)`` x ``(..., M, 4)``;
    union <= 0 gives 0 (reference: utils/iou.hpp:63-99)."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    xx1 = torch.maximum(a[..., 0], b[..., 0])
    yy1 = torch.maximum(a[..., 1], b[..., 1])
    xx2 = torch.minimum(a[..., 2], b[..., 2])
    yy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (xx2 - xx1).clamp_min(0.0) * (yy2 - yy1).clamp_min(0.0)
    union = _areas(b1)[..., :, None] + _areas(b2)[..., None, :] - inter
    return _where0(union > 0.0, inter, union)


def hmiou_batch(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Height-modified IoU: IoU times the vertical intersection over
    union (reference: utils/iou.hpp:122-150)."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    inter_h = (torch.minimum(a[..., 3], b[..., 3])
               - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0.0)
    union_h = (torch.maximum(a[..., 3], b[..., 3])
               - torch.minimum(a[..., 1], b[..., 1])).clamp_min(1e-10)
    return iou_batch(b1, b2) * inter_h / union_h


def _enclosing_wh(a: torch.Tensor, b: torch.Tensor):
    xxc1 = torch.minimum(a[..., 0], b[..., 0])
    yyc1 = torch.minimum(a[..., 1], b[..., 1])
    xxc2 = torch.maximum(a[..., 2], b[..., 2])
    yyc2 = torch.maximum(a[..., 3], b[..., 3])
    return xxc2 - xxc1, yyc2 - yyc1


def giou_batch(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Generalised IoU rescaled to [0, 1] (reference:
    utils/iou.hpp:155-192), with the intersection recovered from the IoU
    as the reference does: ``iou * (A1 + A2) / (iou + 1e-10)``."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    iou = iou_batch(b1, b2)
    wc, hc = _enclosing_wh(a, b)
    area_enclose = wc * hc
    area1 = _areas(b1)[..., :, None]
    area2 = _areas(b2)[..., None, :]
    inter = iou * (area1 + area2) / (iou + 1e-10)
    union = area1 + area2 - inter
    giou = iou - (area_enclose - union) / (area_enclose + 1e-10)
    return (giou + 1.0) / 2.0


def _center_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    cx1 = (a[..., 0] + a[..., 2]) * 0.5
    cy1 = (a[..., 1] + a[..., 3]) * 0.5
    cx2 = (b[..., 0] + b[..., 2]) * 0.5
    cy2 = (b[..., 1] + b[..., 3]) * 0.5
    return (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2


def diou_batch(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Distance IoU rescaled to [0, 1] (reference: utils/iou.hpp:258-295)."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    iou = iou_batch(b1, b2)
    inner = _center_dist2(a, b)
    wc, hc = _enclosing_wh(a, b)
    outer = wc ** 2 + hc ** 2
    diou = iou - inner / (outer + 1e-10)
    return (diou + 1.0) / 2.0


def ciou_batch(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Complete IoU with the aspect-ratio penalty, rescaled to [0, 1]
    (reference: utils/iou.hpp:197-253)."""
    eps = 1e-7
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    iou = iou_batch(b1, b2)
    inner = _center_dist2(a, b)
    wc, hc = _enclosing_wh(a, b)
    outer = wc ** 2 + hc ** 2 + eps
    w1 = a[..., 2] - a[..., 0]
    h1 = a[..., 3] - a[..., 1]
    w2 = b[..., 2] - b[..., 0]
    h2 = b[..., 3] - b[..., 1]
    arctan_diff = torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))
    v = (4.0 / (math.pi ** 2)) * arctan_diff ** 2
    s = 1.0 - iou
    alpha = v / (s + v + eps)
    ciou = iou - inner / outer + alpha * v
    return (ciou + 1.0) / 2.0


def centroid_batch(b1: torch.Tensor, b2: torch.Tensor, frame_width: int,
                   frame_height: int) -> torch.Tensor:
    """1 - normalised centroid distance (reference: utils/iou.hpp:300-333)."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    d = torch.sqrt(_center_dist2(a, b))
    norm = math.sqrt(float(frame_width) ** 2 + float(frame_height) ** 2)
    return 1.0 - d / norm


def centroid_batch_obb(b1: torch.Tensor, b2: torch.Tensor, frame_width: int,
                       frame_height: int) -> torch.Tensor:
    """Centroid similarity of oriented boxes, whose centres are columns
    0:2 (reference: utils/iou.hpp:338-366)."""
    dx = b1[..., :, None, 0] - b2[..., None, :, 0]
    dy = b1[..., :, None, 1] - b2[..., None, :, 1]
    d = torch.sqrt(dx ** 2 + dy ** 2)
    norm = math.sqrt(float(frame_width) ** 2 + float(frame_height) ** 2)
    return 1.0 - d / norm


# ---------------------------------------------------------------------------
# Oriented (rotated) box IoU: a fixed-capacity convex clip
# ---------------------------------------------------------------------------

_P_CAP = 12  # two quads intersect in at most 8 vertices; 12 gives slack


def _obb_corners(obb: torch.Tensor) -> torch.Tensor:
    """(..., 5) [cx, cy, w, h, angle_rad] -> (..., 4, 2) corners, CCW."""
    cx, cy, w, h, ang = obb.unbind(-1)
    c, s = torch.cos(ang), torch.sin(ang)
    dx = torch.stack([-w, w, w, -w], dim=-1) * 0.5
    dy = torch.stack([-h, -h, h, h], dim=-1) * 0.5
    x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
    y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
    return torch.stack([x, y], dim=-1)


def _compact_front(pts: torch.Tensor, mask: torch.Tensor):
    """Move the valid rows of a padded vertex list to the front, in
    order (a stable sort on ~mask), and the validity of the result."""
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    pts_c = pts.gather(-2, order[..., None].expand(pts.shape))
    n = mask.sum(-1)
    idx = torch.arange(pts.shape[-2], device=pts.device)
    return pts_c, idx < n[..., None]


def _next_vertex(pts: torch.Tensor, valid: torch.Tensor):
    """Each vertex's successor along a front-packed polygon (the first
    after the last valid one) and the vertex count."""
    P = pts.shape[-2]
    n = valid.sum(-1)
    idx = torch.arange(P, device=pts.device)
    nxt_idx = torch.where(idx + 1 >= n[..., None], 0, idx + 1)
    return pts.gather(-2, nxt_idx[..., None].expand(pts.shape)), n, idx


def _clip_halfplane(pts: torch.Tensor, valid: torch.Tensor, a, b, c):
    """One Sutherland-Hodgman step: clip the padded convex polygon by
    the half-plane a x + b y + c >= 0; emits up to 2P vertices and keeps
    the first P after compaction."""
    P = pts.shape[-2]
    nxt, n, idx = _next_vertex(pts, valid)
    d_cur = a[..., None] * pts[..., 0] + b[..., None] * pts[..., 1] + c[..., None]
    d_nxt = a[..., None] * nxt[..., 0] + b[..., None] * nxt[..., 1] + c[..., None]
    inside_cur = d_cur >= 0.0
    inside_nxt = d_nxt >= 0.0
    denom = d_cur - d_nxt
    t = d_cur / torch.where(denom.abs() > 1e-12, denom,
                            torch.full_like(denom, 1e-12))
    inter = pts + t[..., None] * (nxt - pts)

    is_edge = idx < n[..., None]
    emit_cur = inside_cur & is_edge
    emit_int = (inside_cur != inside_nxt) & is_edge
    # interleave [cur_0, inter_0, cur_1, inter_1, ...] to keep edge order
    out_pts = torch.stack([pts, inter], dim=-2).reshape(
        pts.shape[:-2] + (2 * P, 2))
    out_mask = torch.stack([emit_cur, emit_int], dim=-1).reshape(
        valid.shape[:-1] + (2 * P,))
    out_pts, out_valid = _compact_front(out_pts, out_mask)
    return out_pts[..., :P, :], out_valid[..., :P]


def _polygon_area(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shoelace area of a front-packed padded polygon."""
    nxt, _, _ = _next_vertex(pts, valid)
    cross = pts[..., 0] * nxt[..., 1] - nxt[..., 0] * pts[..., 1]
    cross = torch.where(valid, cross, torch.zeros_like(cross))
    return 0.5 * cross.sum(-1).abs()


def iou_obb_pair(obb1: torch.Tensor, obb2: torch.Tensor) -> torch.Tensor:
    """IoU of oriented boxes ``(..., 5)`` by clipping the first box's
    quad by the four edges of the second (reference: utils/iou.hpp:30-56)."""
    c1 = _obb_corners(obb1)  # (..., 4, 2)
    c2 = _obb_corners(obb2)
    batch = c1.shape[:-2]
    pts = torch.cat([c1, c1.new_zeros(batch + (_P_CAP - 4, 2))], dim=-2)
    valid = torch.cat([
        torch.ones(batch + (4,), dtype=torch.bool, device=c1.device),
        torch.zeros(batch + (_P_CAP - 4,), dtype=torch.bool, device=c1.device),
    ], dim=-1)
    for k in range(4):
        p0 = c2[..., k, :]
        p1 = c2[..., (k + 1) % 4, :]
        # inward normal of a CCW polygon edge: (-(y1 - y0), x1 - x0)
        a = -(p1[..., 1] - p0[..., 1])
        b = p1[..., 0] - p0[..., 0]
        c = -(a * p0[..., 0] + b * p0[..., 1])
        pts, valid = _clip_halfplane(pts, valid, a, b, c)
    inter = _polygon_area(pts, valid)
    inter = torch.where(valid.sum(-1) >= 3, inter, torch.zeros_like(inter))
    area1 = obb1[..., 2] * obb1[..., 3]
    area2 = obb2[..., 2] * obb2[..., 3]
    union = area1 + area2 - inter
    return _where0(union > 0.0, inter, union)


def iou_batch_obb(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pairwise oriented-box IoU ``(..., N, 5)`` x ``(..., M, 5)``
    (reference: utils/iou.hpp:105-117)."""
    a, b = torch.broadcast_tensors(b1[..., :, None, :], b2[..., None, :, :])
    return iou_obb_pair(a, b)


# ---------------------------------------------------------------------------
# Dispatch (reference: utils/iou.hpp:371-412 AssociationFunction)
# ---------------------------------------------------------------------------

ASSO_FUNCS = (
    "iou",
    "iou_obb",
    "hmiou",
    "giou",
    "ciou",
    "diou",
    "centroid",
    "centroid_obb",
)


def get_asso_fn(mode: str, frame_width: int = 0, frame_height: int = 0):
    """The similarity function named ``mode`` (reference:
    utils/iou.hpp:385-409); the centroid variants keep the frame size."""
    fns = {"iou": iou_batch, "iou_obb": iou_batch_obb, "hmiou": hmiou_batch,
           "giou": giou_batch, "ciou": ciou_batch, "diou": diou_batch}
    if mode in fns:
        return fns[mode]
    if mode == "centroid":
        return lambda a, b: centroid_batch(a, b, frame_width, frame_height)
    if mode == "centroid_obb":
        return lambda a, b: centroid_batch_obb(a, b, frame_width, frame_height)
    raise ValueError(f"Invalid association mode: {mode}")
