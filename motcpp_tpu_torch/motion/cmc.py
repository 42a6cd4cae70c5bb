"""Camera-motion compensation: the host ECC and sparse-flow estimators,
and both estimators in plain torch.

A copy of ``motcpp_tpu/motion/cmc.py``'s ``ECC``, ``SOF``, ``SOFJax``,
``sof_jax_batch``, ``ECCJax``, ``ecc_jax_batch`` and ``create_cmc`` (the
port imports nothing of the JAX package). Each estimator returns the
reference's (2, 3) affine warp contract, the identity on failure:

  * :class:`ECC` is the reference's enhanced-correlation alignment
    (reference: src/motion/cmc/{cmc,ecc}.cpp): grayscale, 0.15x
    downscale, ``cv2.findTransformECC`` with MOTION_TRANSLATION,
    translation rescaled by 1/scale, identity on non-convergence;
  * :class:`SOF` is the reference's sparse optical flow (reference:
    src/motion/cmc/sof.cpp): goodFeaturesToTrack (1000 corners, quality
    0.01), cornerSubPix, pyramidal LK (21x21, 3 levels) and RANSAC
    estimateAffinePartial2D; fewer than 4 tracked points give the
    identity;
  * :class:`SOFJax` and :func:`sof_jax_batch` are the JAX package's
    device estimator in plain torch: Harris corners, Lucas-Kanade on a
    fixed set of the strongest corners and a least-squares partial
    affine with one residual-trim pass, at fixed shapes, batched over
    streams;
  * :class:`ECCJax` and :func:`ecc_jax_batch` are the JAX package's
    device ECC in plain torch: a phase-correlation integer shift, then
    a fixed number of Gauss-Newton steps on the translation residual,
    batched over streams (``parallel/streams.py`` runs it in the
    rollout as the live camera-motion leg).

OpenCV stays optional: without it ``ECC.apply`` returns the identity and
``SOF.apply`` falls back to a fresh :class:`SOFJax`, as in the JAX
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device

IDENTITY = np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)


def _to_gray(img):
    img = np.asarray(img)
    if img.ndim == 2:
        return img.astype(np.float32)
    # BGR weights (reference converts with cv2.cvtColor BGR2GRAY)
    return (
        0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    ).astype(np.float32)


class ECC:
    """Enhanced-correlation-coefficient alignment (translation model)."""

    def __init__(self, scale: float = 0.15, max_iter: int = 100,
                 eps: float = 1e-5):
        self.scale = scale
        self.max_iter = max_iter
        self.eps = eps
        self._prev = None

    def apply(self, img, dets=None) -> np.ndarray:
        try:
            import cv2
        except ImportError:
            return IDENTITY.copy()
        gray = _to_gray(img).astype(np.uint8)
        small = cv2.resize(gray, None, fx=self.scale, fy=self.scale)
        if self._prev is None:
            self._prev = small
            return IDENTITY.copy()
        warp = np.eye(2, 3, dtype=np.float32)
        try:
            criteria = (
                cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                self.max_iter,
                self.eps,
            )
            _, warp = cv2.findTransformECC(
                self._prev, small, warp, cv2.MOTION_TRANSLATION, criteria
            )
            warp = warp.copy()
            warp[:, 2] /= self.scale  # rescale translation (ecc.cpp:70-80)
        except cv2.error:
            warp = IDENTITY.copy()  # StsNoConv -> identity (ecc.cpp:83-90)
        self._prev = small
        return warp.astype(np.float32)

    def reset(self):
        self._prev = None


class SOF:
    """Sparse-optical-flow alignment (reference: sof.cpp:24-180).
    ``device`` is where the fallback without OpenCV runs."""

    def __init__(self, scale: float = 0.15, device="cuda"):
        self.scale = scale
        self.device = device
        self._prev = None
        self._prev_pts = None

    @staticmethod
    def _detect(cv2, gray):
        """goodFeaturesToTrack and sub-pixel refinement (the reference
        refines every corner set, sof.cpp:47,105,165: cornerSubPix with a
        5x5 window, 30 iterations or 0.01 eps)."""
        pts = cv2.goodFeaturesToTrack(
            gray, maxCorners=1000, qualityLevel=0.01, minDistance=1
        )
        if pts is not None and len(pts) > 0:
            criteria = (
                cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 30, 0.01
            )
            pts = cv2.cornerSubPix(gray, pts, (5, 5), (-1, -1), criteria)
        return pts

    def apply(self, img, dets=None) -> np.ndarray:
        try:
            import cv2
        except ImportError:
            # a fresh estimator each frame, as the JAX package's fallback
            return SOFJax(device=self.device).apply(img, dets)
        gray = _to_gray(img).astype(np.uint8)
        if self.scale != 1.0:
            gray = cv2.resize(gray, None, fx=self.scale, fy=self.scale)
        if self._prev is None:
            self._prev = gray
            self._prev_pts = self._detect(cv2, gray)
            return IDENTITY.copy()
        warp = IDENTITY.copy()
        pts = self._prev_pts
        if pts is not None and len(pts) >= 4:
            nxt, st, _ = cv2.calcOpticalFlowPyrLK(
                self._prev, gray, pts, None,
                winSize=(21, 21), maxLevel=3,
            )
            good = st.reshape(-1) == 1
            if good.sum() >= 4:
                m, _ = cv2.estimateAffinePartial2D(
                    pts[good], nxt[good], method=cv2.RANSAC
                )
                if m is not None:
                    warp = m.astype(np.float32)
                    warp[:, 2] /= self.scale
        self._prev = gray
        self._prev_pts = self._detect(cv2, gray)
        return warp

    def reset(self):
        self._prev = None
        self._prev_pts = None


# ---------------------------------------------------------------------------
# the sparse-flow estimator in plain torch
# ---------------------------------------------------------------------------


def _resize_weights(in_size: int, out_size: int, device):
    """(in_size, out_size) weights of a linear resize along one axis,
    with the triangle kernel widened by the downscale factor (an
    antialiasing filter), as ``jax.image.resize(..., "linear")`` builds
    them (``compute_weight_mat``): half-pixel centres, each column
    normalised, columns whose sample falls outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32,
                                device=device)
    inv = torch.tensor(inv_scale, dtype=torch.float32, device=device)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    weights = (1.0 - (x / kernel_scale).abs()).clamp_min(0.0)
    total = weights.sum(0, keepdim=True)
    eps32 = float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps32,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_linear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Antialiased linear resize of (..., H, W) float32 images to
    ``out_hw``, the counterpart of ``jax.image.resize(img, out_hw,
    "linear")``: the separable weights of :func:`_resize_weights`, rows
    then columns. An axis whose size does not change is left as is."""
    H, W = img.shape[-2:]
    nh, nw = out_hw
    if nh != H:
        wh = _resize_weights(H, nh, img.device)
        img = torch.matmul(wh.transpose(0, 1), img)
    if nw != W:
        ww = _resize_weights(W, nw, img.device)
        img = torch.matmul(img, ww)
    return img


def _gradients(im):
    gx = (torch.roll(im, -1, -1) - torch.roll(im, 1, -1)) * 0.5
    gy = (torch.roll(im, -1, -2) - torch.roll(im, 1, -2)) * 0.5
    return gx, gy


def _box_blur(im, r=2):
    k = 2 * r + 1
    im = torch.cumsum(im, dim=-2)
    im = (torch.roll(im, -r, -2) - torch.roll(im, r + 1, -2)) / k
    im = torch.cumsum(im, dim=-1)
    return (torch.roll(im, -r, -1) - torch.roll(im, r + 1, -1)) / k


def _bilinear(im, ys, xs):
    """Bilinear samples of (S, H, W) images at (S, C, P) points, edge
    indices clamped."""
    S, H, W = im.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = y0.to(torch.int64).clamp(0, H - 1)
    x0i = x0.to(torch.int64).clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    flat = im.reshape(S, 1, H * W).expand(S, ys.shape[1], H * W)

    def at(yi, xi):
        return flat.gather(-1, yi * W + xi)

    return (at(y0i, x0i) * (1 - wy) * (1 - wx)
            + at(y0i, x1i) * (1 - wy) * wx
            + at(y1i, x0i) * wy * (1 - wx)
            + at(y1i, x1i) * wy * wx)


def sof_jax_batch(prev, cur, n_corners: int = 256, win: int = 10,
                  levels: int = 3):
    """Camera motion of many streams at once: Harris corners on prev,
    Lucas-Kanade to cur and a least-squares partial affine, for (S, H, W)
    float32 grayscale pairs -> ((S, 2, 3) warps, (S,) ok flags), on the
    tensors' device. Streams whose fit fails get the identity and ok
    False."""
    S, H, W = prev.shape
    dev = prev.device
    gx, gy = _gradients(prev)
    ixx = _box_blur(gx * gx)
    iyy = _box_blur(gy * gy)
    ixy = _box_blur(gx * gy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    harris = det - 0.04 * tr * tr
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    margin = win + 2
    border = ((yy < margin) | (yy >= H - margin) | (xx < margin)
              | (xx >= W - margin))
    harris = torch.where(border, -torch.inf, harris)
    # the strongest corners, the lowest index first among equal scores
    # (as lax.top_k)
    top = torch.sort(harris.reshape(S, -1), dim=-1, descending=True,
                     stable=True)[1][:, :n_corners]
    cy = torch.div(top, W, rounding_mode="floor").to(torch.float32)
    cx = (top % W).to(torch.float32)

    cgx, cgy = _gradients(cur)
    offs = torch.arange(-win, win + 1, dtype=torch.float32, device=dev)
    n_off = 2 * win + 1
    oy = offs[:, None].expand(n_off, n_off).reshape(-1)
    ox = offs[None, :].expand(n_off, n_off).reshape(-1)
    ys = cy[..., None] + oy
    xs = cx[..., None] + ox
    tmpl = _bilinear(prev, ys, xs)  # the template from prev at the corners

    def lk_level(dy, dx):
        """Five Lucas-Kanade iterations from the displacement (dy, dx)."""
        for _ in range(5):
            ys2 = ys + dy[..., None]
            xs2 = xs + dx[..., None]
            i = _bilinear(cur, ys2, xs2)
            gx_p = _bilinear(cgx, ys2, xs2)
            gy_p = _bilinear(cgy, ys2, xs2)
            err = tmpl - i
            a11 = (gx_p * gx_p).sum(-1) + 1e-6
            a12 = (gx_p * gy_p).sum(-1)
            a22 = (gy_p * gy_p).sum(-1) + 1e-6
            b1 = (gx_p * err).sum(-1)
            b2 = (gy_p * err).sum(-1)
            det_a = a11 * a22 - a12 * a12
            ddx = (a22 * b1 - a12 * b2) / det_a
            ddy = (a11 * b2 - a12 * b1) / det_a
            dy, dx = dy + ddy, dx + ddx
        return dy, dx

    dy = torch.zeros_like(cy)
    dx = torch.zeros_like(cx)
    for _ in range(levels):
        dy, dx = lk_level(dy, dx)

    # valid: a small residual and a reasonable displacement
    i = _bilinear(cur, ys + dy[..., None], xs + dx[..., None])
    resid = (tmpl - i).abs().mean(-1)
    disp = torch.sqrt(dy * dy + dx * dx)
    ok = (resid < 10.0) & (disp < 0.2 * float(max(H, W)))

    def fit(mask):
        """Least-squares partial affine [a, -b, tx; b, a, ty] on the
        masked points."""
        wgt = mask.to(torch.float32)
        n = wgt.sum(-1) + 1e-6
        qx = cx + dx
        qy = cy + dy
        mpx = (wgt * cx).sum(-1) / n
        mpy = (wgt * cy).sum(-1) / n
        mqx = (wgt * qx).sum(-1) / n
        mqy = (wgt * qy).sum(-1) / n
        cpx = cx - mpx[:, None]
        cpy = cy - mpy[:, None]
        cqx = qx - mqx[:, None]
        cqy = qy - mqy[:, None]
        sxx = (wgt * (cpx * cqx + cpy * cqy)).sum(-1)
        sxy = (wgt * (cpx * cqy - cpy * cqx)).sum(-1)
        d = (wgt * (cpx * cpx + cpy * cpy)).sum(-1) + 1e-6
        a = sxx / d
        b = sxy / d
        tx = mqx - (a * mpx - b * mpy)
        ty = mqy - (b * mpx + a * mpy)
        return a, b, tx, ty

    a, b, tx, ty = fit(ok)
    # one residual trim pass
    rx = (a[:, None] * cx - b[:, None] * cy + tx[:, None]) - (cx + dx)
    ry = (b[:, None] * cx + a[:, None] * cy + ty[:, None]) - (cy + dy)
    r = torch.sqrt(rx * rx + ry * ry)
    srt = torch.sort(torch.where(ok, r, 1e3), dim=-1)[0]
    mid = n_corners // 2
    median = ((srt[:, mid - 1] + srt[:, mid]) * 0.5 if n_corners % 2 == 0
              else srt[:, mid])
    ok2 = ok & (r < torch.clamp_min(2.0 * median, 2.0)[:, None])
    a, b, tx, ty = fit(ok2)

    enough = ok2.sum(-1) >= 4
    warp = torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], -2)
    ident = torch.eye(2, 3, device=dev)
    return torch.where(enough[:, None, None], warp, ident), enough


class SOFJax:
    """The sparse-flow estimator of :func:`sof_jax_batch` for one
    stream, on ``device``: each frame is downscaled by ``scale`` (at
    least 32 px a side) and aligned with the previous one."""

    def __init__(self, scale: float = 0.25, n_corners: int = 256,
                 device="cuda"):
        self.scale = scale
        self.n_corners = n_corners
        self.device = resolve_device(device)
        self._prev = None

    def _downscale(self, gray):
        """The downscaled frame and the per-axis scales it achieved (the
        32 px floor and the truncation make them differ from ``scale``);
        translations are rescaled by these."""
        h, w = gray.shape
        nh, nw = max(int(h * self.scale), 32), max(int(w * self.scale), 32)
        small = resize_linear(torch.from_numpy(gray).to(self.device),
                              (nh, nw))
        return small, (nh / h, nw / w)

    def apply(self, img, dets=None) -> np.ndarray:
        small, (sy, sx) = self._downscale(_to_gray(img))
        if self._prev is None or self._prev.shape != small.shape:
            self._prev = small
            return IDENTITY.copy()
        warp, _ = sof_jax_batch(self._prev[None], small[None],
                                n_corners=self.n_corners)
        warp = warp[0].cpu().numpy()
        warp[0, 2] /= sx
        warp[1, 2] /= sy
        self._prev = small
        return warp

    def reset(self):
        self._prev = None


# ---------------------------------------------------------------------------
# the ECC estimator in plain torch
# ---------------------------------------------------------------------------


def _hann(n: int, device):
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * i / n)


def phase_shift(prev, cur):
    """The integer shift (tx, ty) of cur against prev per stream, as
    float32 (S,) each, by phase correlation: the Hann-windowed
    cross-power spectrum's first maximum, wrapped past the midpoint to
    a negative shift."""
    S, H, W = prev.shape
    win = _hann(H, prev.device)[:, None] * _hann(W, prev.device)[None, :]
    f1 = torch.fft.rfft2((prev - prev.mean((-2, -1), keepdim=True)) * win)
    f2 = torch.fft.rfft2((cur - cur.mean((-2, -1), keepdim=True)) * win)
    xps = f1 * torch.conj(f2)
    xps = xps / (torch.abs(xps) + 1e-9)
    corr = torch.fft.irfft2(xps, s=(H, W))
    peak = corr.reshape(S, -1).argmax(-1)  # the first maximum
    py = torch.div(peak, W, rounding_mode="floor").to(torch.float32)
    px = (peak % W).to(torch.float32)
    py = torch.where(py > H / 2, py - H, py)
    px = torch.where(px > W / 2, px - W, px)
    # the peak is at -p (mod the size) for cur = prev shifted by +p
    return -px, -py


def ecc_jax_batch(prev, cur, n_iters: int = 8):
    """Translation-only ECC alignment of many streams at once: (S, H, W)
    float32 grayscale pairs, already at CMC scale, -> ((S, 2, 3) warps
    mapping prev coordinates to cur's, (S,) ok flags), on the tensors'
    device. The warp W satisfies cur(W(x)) ~= prev(x), as the
    reference's ``cv2.findTransformECC`` with MOTION_TRANSLATION
    (reference: src/motion/cmc/ecc.cpp:22-98); a stream that does not
    converge, or whose frames are flat, gets the identity and ok False.

    The JAX package's ``_ecc_jax_core`` over a stream batch:

      1. phase correlation (:func:`phase_shift`) gives each stream's
         integer shift, also far outside Gauss-Newton's basin;
      2. ``n_iters`` forward-additive Gauss-Newton steps on the
         zero-mean correlation refine the sub-pixel residual over the
         interior (an 8 px margin), with cur aligned by the integer
         shift (wrapping, as ``jnp.roll``) and resampled bilinearly
         from four windows at each stream's offset, blended in the JAX
         package's order of terms. A stream stops moving once its step
         is below 1e-4 px or fails; every iteration runs for every
         stream, with no host synchronisation.
    """
    S, H, W = prev.shape
    dev = prev.device
    prev = prev.to(torch.float32)
    cur = cur.to(torch.float32)
    tx0, ty0 = phase_shift(prev, cur)

    # --- ECC refinement over the interior -------------------------------
    m = 8
    ih, iw = H - 2 * m, W - 2 * m
    res_max = float(m - 2)  # keeps every window inside the frame
    ti_y = torch.round(ty0).to(torch.int64)
    ti_x = torch.round(tx0).to(torch.int64)
    # the aligned interior, eroded by the residual clamp and one pixel
    # for the gradient stencil inside the window
    yy = torch.arange(m, H - m, device=dev)
    xx = torch.arange(m, W - m, device=dev)
    src_y = yy + ti_y[:, None]  # (S, ih): the rows of cur they come from
    src_x = xx + ti_x[:, None]  # (S, iw)
    vy = (src_y >= m) & (src_y <= H - 1 - m) & (yy > m) & (yy < H - 1 - m)
    vx = (src_x >= m) & (src_x <= W - 1 - m) & (xx > m) & (xx < W - 1 - m)
    wgt = (vy[:, :, None] & vx[:, None, :]).to(torch.float32)
    n_w = wgt.sum((-2, -1)) + 1e-9

    rows_h = torch.arange(ih, device=dev)
    cols_w = torch.arange(iw, device=dev)

    def total(a):
        return a.sum((-2, -1))

    def sample_interior(ry, rx):
        """cur aligned by the integer shift, sampled bilinearly at the
        interior grid + (ry, rx) per stream, |r| <= res_max: four
        windows at offsets clamped as ``lax.dynamic_slice`` clamps
        them, read from cur with the integer shift's wrap."""
        y0 = torch.floor(ry)
        x0 = torch.floor(rx)
        fy = (ry - y0)[:, None, None]
        fx = (rx - x0)[:, None, None]
        sy = m + y0.to(torch.int64)
        sx = m + x0.to(torch.int64)

        def rows(dy):
            start = (sy + dy).clamp(0, H - ih)
            idx = (start[:, None] + rows_h + ti_y[:, None]) % H  # (S, ih)
            return cur.gather(1, idx[:, :, None].expand(S, ih, W))

        def cols(band, dx):
            start = (sx + dx).clamp(0, W - iw)
            idx = (start[:, None] + cols_w + ti_x[:, None]) % W  # (S, iw)
            return band.gather(2, idx[:, None, :].expand(S, ih, iw))

        r0, r1 = rows(0), rows(1)
        return (cols(r0, 0) * (1 - fy) * (1 - fx)
                + cols(r0, 1) * (1 - fy) * fx
                + cols(r1, 0) * fy * (1 - fx)
                + cols(r1, 1) * fy * fx)

    tmpl = prev[:, m:H - m, m:W - m]
    tbar = (tmpl - (total(wgt * tmpl) / n_w)[:, None, None]) * wgt
    t_norm2 = total(tbar * tbar)

    def zero_mean(a):
        return (a - (total(wgt * a) / n_w)[:, None, None]) * wgt

    rx = tx0 - ti_x.to(torch.float32)
    ry = ty0 - ti_y.to(torch.float32)
    frozen = torch.zeros(S, dtype=torch.bool, device=dev)
    rho = torch.zeros(S, device=dev)
    for _ in range(n_iters):
        iwin = sample_interior(ry, rx)
        # gradients by central differences within the window (the
        # eroded weights mask the band the roll wraps)
        gxw = (torch.roll(iwin, -1, -1) - torch.roll(iwin, 1, -1)) * 0.5
        gyw = (torch.roll(iwin, -1, -2) - torch.roll(iwin, 1, -2)) * 0.5
        ibar = zero_mean(iwin)
        gxb = zero_mean(gxw)
        gyb = zero_mean(gyw)
        # the 2x2 Gram of the translation Jacobian's columns
        c11 = total(gxb * gxb) + 1e-9
        c12 = total(gxb * gyb)
        c22 = total(gyb * gyb) + 1e-9
        detc = c11 * c22 - c12 * c12
        iv1 = total(gxb * ibar)
        iv2 = total(gyb * ibar)
        tv1 = total(gxb * tbar)
        tv2 = total(gyb * tbar)

        def cinv(v1, v2):
            return ((c22 * v1 - c12 * v2) / detc,
                    (c11 * v2 - c12 * v1) / detc)

        ci1, ci2 = cinv(iv1, iv2)
        i_norm2 = total(ibar * ibar)
        num = i_norm2 - (iv1 * ci1 + iv2 * ci2)
        tdot = total(tbar * ibar)
        den = tdot - (tv1 * ci1 + tv2 * ci2)
        # den <= 0: the correlation cannot increase; hold
        lam = num / torch.where(den > 1e-9, den, 1.0)
        d1, d2 = cinv(lam * tv1 - iv1, lam * tv2 - iv2)
        step_ok = (den > 1e-9) & torch.isfinite(d1) & torch.isfinite(d2)
        upd = step_ok & ~frozen
        rx = torch.clamp(torch.where(upd, rx + d1, rx), -res_max, res_max)
        ry = torch.clamp(torch.where(upd, ry + d2, ry), -res_max, res_max)
        frozen = frozen | (torch.sqrt(d1 * d1 + d2 * d2) < 1e-4) | ~step_ok
        rho = tdot / (torch.sqrt(t_norm2 * i_norm2) + 1e-9)
    tx = ti_x.to(torch.float32) + rx
    ty = ti_y.to(torch.float32) + ry
    ok = (torch.isfinite(tx) & torch.isfinite(ty) & (rho > 0.2)
          & (tx.abs() < 0.5 * W) & (ty.abs() < 0.5 * H)
          # enough valid overlap for the masked statistics to mean anything
          & (n_w > 0.25 * ih * iw))
    # made on the device: a copy from the host would wait for the queue
    ident = torch.eye(2, 3, device=dev)
    warp = ident.expand(S, 2, 3).clone()
    warp[:, 0, 2] = tx
    warp[:, 1, 2] = ty
    return torch.where(ok[:, None, None], warp, ident), ok


class ECCJax:
    """The ECC estimator of :func:`ecc_jax_batch` for one stream, on
    ``device``: the host :class:`ECC`'s contract (grayscale, downscale by
    ``scale`` to at least 32 px a side, identity first) with the
    translation rescaled by the per-axis scales the downscale achieved;
    needs no OpenCV."""

    def __init__(self, scale: float = 0.15, n_iters: int = 8, device="cuda"):
        self.scale = scale
        self.n_iters = n_iters
        self.device = resolve_device(device)
        self._prev = None

    def _downscale(self, gray):
        """The downscaled frame and the per-axis scales it achieved (the
        32 px floor and the truncation make them differ from ``scale``);
        translations are rescaled by these."""
        h, w = gray.shape
        nh, nw = max(int(h * self.scale), 32), max(int(w * self.scale), 32)
        small = resize_linear(torch.from_numpy(gray).to(self.device),
                              (nh, nw))
        return small, (nh / h, nw / w)

    def apply(self, img, dets=None) -> np.ndarray:
        small, (sy, sx) = self._downscale(_to_gray(img))
        if self._prev is None or self._prev.shape != small.shape:
            self._prev = small
            return IDENTITY.copy()
        warp, _ = ecc_jax_batch(self._prev[None], small[None],
                                n_iters=self.n_iters)
        warp = warp[0].cpu().numpy()
        warp[0, 2] /= sx
        warp[1, 2] /= sy
        self._prev = small
        return warp

    def reset(self):
        self._prev = None


def create_cmc(method: str = "ecc", prefer_jax: bool = False, device="cuda"):
    """The estimator for ``method`` (the reference's cmc_method
    dispatch): None for ``"none"`` or ``""``; ``"sof_jax"``, or
    ``prefer_jax`` with ``"sof"`` or an unknown method, gives
    :class:`SOFJax` on ``device``; ``"ecc_jax"``, or ``prefer_jax`` with
    ``"ecc"``, :class:`ECCJax` on ``device``; ``"sof"`` :class:`SOF`;
    ``"ecc"`` :class:`ECC`. An unknown method raises ValueError."""
    if method in ("", "none", None):
        return None
    if method == "sof_jax" or (prefer_jax and method == "sof"):
        return SOFJax(device=device)
    if method == "ecc_jax" or (prefer_jax and method == "ecc"):
        return ECCJax(device=device)
    if prefer_jax:
        return SOFJax(device=device)
    if method == "sof":
        return SOF(device=device)
    if method == "ecc":
        return ECC()
    raise ValueError(f"Unknown cmc method: {method}")
