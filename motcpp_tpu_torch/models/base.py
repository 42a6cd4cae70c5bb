"""Host-facing tracker wrapper: padding to capacity and the
``update(dets, img, embs) -> (M, 8)`` contract.

Counterpart of ``motcpp_tpu/models/base.py::BaseTrackerWrapper``. Each
tracker supplies a step over fixed-capacity slot state with a leading
stream dimension,

    step(state, dets (S, N, 6), det_mask (S, N), embs (S, N, E),
         warp (S, 2, 3)) -> (state, (out, out_mask)),

and the wrapper runs it for one stream (S = 1): it checks the input,
pads the detections and embeddings to ``max_dets``, asks the
``_compute_warp`` hook for the camera-motion warp (None means identity),
keeps the state on ``device`` and compacts the masked (K, 8) output to
the dense (M, 8) result. Trackers without appearance or camera motion
ignore ``embs`` and ``warp``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device

IDENTITY_WARP = np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)


def pad_rows(arr: np.ndarray, capacity: int, fill: float = 0.0) -> np.ndarray:
    """Pad the leading axis to a static capacity; raise if it is larger."""
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(
            f"{n} rows exceed the configured capacity {capacity}; "
            f"construct the tracker with a larger max_dets"
        )
    out = np.full((capacity,) + arr.shape[1:], fill, arr.dtype)
    out[:n] = arr
    return out


class BaseTrackerWrapper:
    """Tracker with the reference's public contract.

    Input (reference: src/tracker.cpp:108-125): dets is (n, 6) AABB
    ``[x1, y1, x2, y2, conf, cls]`` or (n, 7) OBB
    ``[cx, cy, w, h, angle, conf, cls]``; the first frame with
    detections sets ``is_obb`` (tracker.cpp:174-183), and each tracker
    reads the columns as its JAX counterpart does. embs is (n, E) or
    None. Output: (M, 8) ``[x1, y1, x2, y2, id, conf, cls, det_ind]``.
    """

    DET_COLS = 6

    def __init__(self, max_dets: int = 128, emb_dim: int = 0, device="cuda"):
        self.max_dets = int(max_dets)
        self.emb_dim = int(emb_dim)
        self.device = resolve_device(device)
        self.frame_width = 0
        self.frame_height = 0
        self._first_frame_processed = False
        self._first_dets_processed = False
        self.is_obb = False
        self._state = None

    def update(self, dets: np.ndarray, img: np.ndarray | None = None,
               embs: np.ndarray | None = None,
               warp: np.ndarray | None = None) -> np.ndarray:
        """Process one frame; returns the (M, 8) confirmed tracks.
        ``warp`` injects a precomputed (2, 3) camera-motion affine in
        place of the tracker's own estimate, as ``embs`` does for the
        appearance features."""
        dets = np.asarray(dets, np.float32)
        if dets.size == 0:
            dets = dets.reshape(0, 7 if self.is_obb else self.DET_COLS)
        self._check_inputs(dets, img, embs)
        self._setup_first_frame(dets, img)

        n = dets.shape[0]
        padded = torch.from_numpy(pad_rows(dets, self.max_dets))
        det_mask = torch.zeros(self.max_dets, dtype=torch.bool)
        det_mask[:n] = True
        if embs is not None and np.asarray(embs).size > 0:
            embs = np.asarray(embs, np.float32)
            if self.emb_dim == 0:
                self.emb_dim = embs.shape[1]
            emb_pad = pad_rows(embs, self.max_dets)
        else:
            emb_pad = np.zeros((self.max_dets, max(self.emb_dim, 1)),
                               np.float32)
        if warp is None:
            warp = self._compute_warp(img, dets)
        if warp is None:
            warp = IDENTITY_WARP
        warp = np.asarray(warp, np.float32).reshape(2, 3)
        if self._state is None:
            self._state = self._init_state()
        self._state, (out, out_mask) = self._step(
            self._state, padded[None].to(self.device),
            det_mask[None].to(self.device),
            torch.from_numpy(emb_pad)[None].to(self.device),
            torch.from_numpy(warp)[None].to(self.device),
        )
        return out[0][out_mask[0]].cpu().numpy()

    def reset(self):
        """Drop all tracks and restart frame counting and track ids
        (reference: src/tracker.cpp:48-56, which keeps its static id
        counters; ids here are per instance, as in the JAX package)."""
        self._state = None
        self._first_frame_processed = False
        self._first_dets_processed = False

    def _check_inputs(self, dets, img, embs):
        if dets.ndim != 2 or dets.shape[1] not in (6, 7):
            raise ValueError("Detections must have 6 (AABB) or 7 (OBB) columns")
        if embs is not None and np.asarray(embs).size > 0:
            if dets.shape[0] != np.asarray(embs).shape[0]:
                raise ValueError(
                    "Detections and embeddings must have same number of rows"
                )

    def _setup_first_frame(self, dets, img):
        """Frame size from the first image (tracker.cpp:166-172) and the
        detection format from the first detections (tracker.cpp:174-183)."""
        if not self._first_frame_processed and img is not None:
            self.frame_height = int(img.shape[0])
            self.frame_width = int(img.shape[1])
            self._first_frame_processed = True
        if not self._first_dets_processed and dets.size > 0:
            self.is_obb = dets.shape[1] == 7
            self._first_dets_processed = True

    def _compute_warp(self, img, dets):
        """Camera-motion warp hook: trackers with camera-motion
        compensation return a (2, 3) affine; None means identity."""
        return None

    def _init_state(self) -> Any:
        raise NotImplementedError

    def _step(self, state, dets, det_mask, embs, warp):
        raise NotImplementedError
