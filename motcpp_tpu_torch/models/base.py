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
    ``[x1, y1, x2, y2, conf, cls]`` (7 columns, OBB, is rejected by the
    trackers that are ported so far); embs is (n, E) or None.
    Output: (M, 8) ``[x1, y1, x2, y2, id, conf, cls, det_ind]``.
    """

    DET_COLS = 6

    def __init__(self, max_dets: int = 128, emb_dim: int = 0, device="cuda"):
        self.max_dets = int(max_dets)
        self.emb_dim = int(emb_dim)
        self.device = resolve_device(device)
        self.frame_width = 0
        self.frame_height = 0
        self._first_frame_processed = False
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

    def _compute_warp(self, img, dets):
        """Camera-motion warp hook: trackers with camera-motion
        compensation return a (2, 3) affine; None means identity."""
        return None

    def _init_state(self) -> Any:
        raise NotImplementedError

    def _step(self, state, dets, det_mask, embs, warp):
        raise NotImplementedError


def birth_slots(free, cand, K):
    """Allocate candidate dets (S, N) to free slots (S, K) in detection
    order; returns births (S, K), det_idx (S, K) and slot rank (S, K)."""
    S, N = cand.shape
    det_rank = torch.cumsum(cand.to(torch.int32), 1, dtype=torch.int32) - 1
    slot_rank = torch.cumsum(free.to(torch.int32), 1, dtype=torch.int32) - 1
    n_cand = cand.sum(1, dtype=torch.int32)
    # scatter det index by rank; ranks >= K (when N > K) and
    # non-candidates land in the extra slot K, which is dropped
    pos_by_rank = torch.full((S, K + 1), N, dtype=torch.int32,
                             device=cand.device)
    rank_idx = torch.where(cand & (det_rank < K), det_rank, K).long()
    det_ids = torch.arange(N, dtype=torch.int32, device=cand.device)
    pos_by_rank.scatter_(1, rank_idx, det_ids.expand(S, N))
    births = free & (slot_rank < n_cand[:, None])
    det_idx = torch.where(
        births, pos_by_rank.gather(1, slot_rank.clamp(0, K - 1).long()), 0)
    return births, det_idx, slot_rank


def gather_rows(rows, idx):
    """rows (S, N, D) gathered at idx (S, K) -> (S, K, D)."""
    return rows.gather(1, idx.long()[..., None].expand(-1, -1, rows.shape[-1]))
