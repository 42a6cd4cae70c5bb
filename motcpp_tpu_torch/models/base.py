"""Host-facing tracker wrapper: padding to capacity and the
``update(dets, img, embs) -> (M, 8)`` contract.

Counterpart of ``motcpp_tpu/models/base.py::BaseTrackerWrapper``. Each
tracker supplies a step over fixed-capacity slot state with a leading
stream dimension,

    step(state, dets (S, N, 6), det_mask (S, N)) -> (state, (out, out_mask)),

and the wrapper runs it for one stream (S = 1): it checks the input,
pads the detections to ``max_dets``, keeps the state on ``device`` and
compacts the masked (K, 8) output to the dense (M, 8) result.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device


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
    ``[x1, y1, x2, y2, conf, cls]`` (7 columns, OBB, is rejected by the
    trackers that are ported so far); embs is (n, E) or None.
    Output: (M, 8) ``[x1, y1, x2, y2, id, conf, cls, det_ind]``.
    """

    DET_COLS = 6

    def __init__(self, max_dets: int = 128, device="cuda"):
        self.max_dets = int(max_dets)
        self.device = resolve_device(device)
        self.frame_width = 0
        self.frame_height = 0
        self._first_frame_processed = False
        self._state = None

    def update(self, dets: np.ndarray, img: np.ndarray | None = None,
               embs: np.ndarray | None = None) -> np.ndarray:
        """Process one frame; returns the (M, 8) confirmed tracks."""
        dets = np.asarray(dets, np.float32)
        if dets.size == 0:
            dets = dets.reshape(0, self.DET_COLS)
        self._check_inputs(dets, img, embs)
        if not self._first_frame_processed and img is not None:
            self.frame_height = int(img.shape[0])
            self.frame_width = int(img.shape[1])
            self._first_frame_processed = True

        n = dets.shape[0]
        padded = torch.from_numpy(pad_rows(dets, self.max_dets))
        det_mask = torch.zeros(self.max_dets, dtype=torch.bool)
        det_mask[:n] = True
        if self._state is None:
            self._state = self._init_state()
        self._state, (out, out_mask) = self._step(
            self._state, padded[None].to(self.device),
            det_mask[None].to(self.device),
        )
        return out[0][out_mask[0]].cpu().numpy()

    def reset(self):
        """Drop all tracks and restart frame counting and track ids
        (reference: src/tracker.cpp:48-56, which keeps its static id
        counters; ids here are per instance, as in the JAX package)."""
        self._state = None
        self._first_frame_processed = False

    def _check_inputs(self, dets, img, embs):
        if dets.ndim != 2 or dets.shape[1] not in (6, 7):
            raise ValueError("Detections must have 6 (AABB) or 7 (OBB) columns")
        if dets.shape[1] == 7:
            raise ValueError("OBB detections are not supported by this tracker")
        if embs is not None and np.asarray(embs).size > 0:
            if dets.shape[0] != np.asarray(embs).shape[0]:
                raise ValueError(
                    "Detections and embeddings must have same number of rows"
                )

    def _init_state(self) -> Any:
        raise NotImplementedError

    def _step(self, state, dets, det_mask):
        raise NotImplementedError
