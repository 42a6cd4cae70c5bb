"""Per-class tracking: one tracker per class id, detections routed by
their class column, outputs merged.

Counterpart of ``motcpp_tpu/models/per_class.py``. The reference's
BaseTracker carries a ``per_class`` flag and a class-splitting helper
(reference: src/tracker.cpp:58-106) that none of its trackers calls;
this wrapper gives it its intended meaning. Each class's track ids are
offset by ``class * ID_STRIDE`` so that they stay unique, and ``det_ind``
refers back to the rows of the unsplit input. It runs on the host over
the wrappers' ``update`` and leaves devices to the trackers it builds.
"""

from __future__ import annotations

import numpy as np


class PerClassTracker:
    """Track each class independently with trackers from ``factory``.

    Example:
        tracker = PerClassTracker(lambda: motcpp_tpu_torch.create_tracker(
            "bytetrack", max_tracks=64), nr_classes=80)
        tracks = tracker.update(dets, img, embs)
    """

    ID_STRIDE = 100000  # per-class id namespace (reference ids stay small)

    def __init__(self, factory, nr_classes: int = 80):
        self.factory = factory
        self.nr_classes = nr_classes
        self._trackers: dict[int, object] = {}

    def update(self, dets, img=None, embs=None, warp=None) -> np.ndarray:
        dets = np.asarray(dets, np.float32)
        if dets.size == 0:
            dets = dets.reshape(0, 6)
        embs_arr = None if embs is None else np.asarray(embs, np.float32)
        outs = []
        classes = {int(c) for c in dets[:, 5]} if dets.shape[0] else set()
        # classes seen before keep updating (and aging) with empty input
        for cls_id in sorted(set(self._trackers) | classes):
            sel = (np.abs(dets[:, 5] - cls_id) < 1e-5 if dets.shape[0]
                   else np.zeros(0, bool))
            cls_dets = dets[sel] if dets.shape[0] else dets
            cls_embs = (embs_arr[sel] if embs_arr is not None
                        and embs_arr.shape[0] == dets.shape[0] else None)
            if cls_id not in self._trackers:
                if cls_dets.shape[0] == 0:
                    continue
                self._trackers[cls_id] = self.factory()
            out = self._trackers[cls_id].update(cls_dets, img, cls_embs,
                                                warp=warp)
            if out.shape[0]:
                out = out.copy()
                out[:, 4] += cls_id * self.ID_STRIDE
                # det_ind refers back to the unsplit rows
                orig_idx = np.nonzero(sel)[0]
                di = out[:, 7].astype(int)
                valid = (di >= 0) & (di < len(orig_idx))
                out[valid, 7] = orig_idx[di[valid]]
                outs.append(out)
        if not outs:
            return np.zeros((0, 8), np.float32)
        return np.concatenate(outs, axis=0)

    def reset(self):
        for t in self._trackers.values():
            t.reset()
        self._trackers.clear()
