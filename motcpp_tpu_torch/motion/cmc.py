"""Camera-motion compensation: the host ECC estimator.

A copy of ``motcpp_tpu/motion/cmc.py::ECC`` and ``create_cmc`` for
``"ecc"`` and ``"none"`` (the port imports nothing of the JAX package).
ECC is the reference's enhanced-correlation alignment (reference:
src/motion/cmc/{cmc,ecc}.cpp): grayscale, 0.15x downscale,
``cv2.findTransformECC`` with MOTION_TRANSLATION, translation rescaled
by 1/scale, identity on non-convergence. OpenCV stays optional: without
it ``ECC.apply`` returns the identity. The sparse-optical-flow and
in-graph estimators are not ported yet.
"""

from __future__ import annotations

import numpy as np

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


def create_cmc(method: str = "ecc"):
    """The estimator for ``method``: ``"ecc"``, or None for ``"none"``
    or ``""``. The other methods of the JAX package raise, not ported."""
    if method in ("", "none", None):
        return None
    if method == "ecc":
        return ECC()
    raise ValueError(f"cmc method {method!r} is not ported (only 'ecc', 'none')")
