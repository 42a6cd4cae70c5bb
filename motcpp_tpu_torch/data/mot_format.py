"""MOT-Challenge result formatting and writing.

A copy of ``motcpp_tpu/data/mot_format.py`` for the port. Mirrors the
reference's converter/appender (reference:
include/motcpp/utils/mot_format.hpp:20-77): tracks (M, 8) become
10-field rows ``frame, id, x1, y1, w, h, conf, -1, -1, -1``; the writer
appends, creating parent directories, with coordinates written as ints
and confidence at 6 decimals.
"""

from __future__ import annotations

import os

import numpy as np


def convert_to_mot_format(tracks: np.ndarray, frame_id: int) -> np.ndarray:
    """(M, 8) [x1,y1,x2,y2,id,conf,cls,det_ind] -> (M, 10) MOT rows."""
    tracks = np.asarray(tracks, np.float32)
    if tracks.shape[0] == 0:
        return np.zeros((0, 10), np.float32)
    out = np.full((tracks.shape[0], 10), -1.0, np.float32)
    out[:, 0] = float(frame_id)
    out[:, 1] = tracks[:, 4]
    out[:, 2] = tracks[:, 0]
    out[:, 3] = tracks[:, 1]
    out[:, 4] = tracks[:, 2] - tracks[:, 0]
    out[:, 5] = tracks[:, 3] - tracks[:, 1]
    out[:, 6] = tracks[:, 5]
    return out


def write_mot_results(output_path, mot_results: np.ndarray) -> None:
    """Append rows in the reference's exact text format (ints for
    frame/id/box/world fields, %.6f confidence): through the native IO
    library where it builds, else in Python, byte for byte the same."""
    output_path = os.fspath(output_path)
    try:
        from motcpp_tpu_torch.utils import native_io

        if native_io.write_mot(output_path, np.asarray(mot_results)):
            return
    except Exception:
        pass
    parent = os.path.dirname(output_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(output_path, "a") as f:
        for row in np.asarray(mot_results):
            f.write(
                f"{int(row[0])},{int(row[1])},{int(row[2])},{int(row[3])},"
                f"{int(row[4])},{int(row[5])},{row[6]:.6f},"
                f"{int(row[7])},{int(row[8])},{int(row[9])}\n"
            )
