"""Track visualization: colored boxes, trajectories, GIF export.

A copy of ``motcpp_tpu/utils/visualization.py``. Host-side equivalent
of the reference's plotting surface (reference: src/tracker.cpp:127-164
id_to_color/plot_results placeholder; scripts/generate_demo_gif*.py
render colored boxes + trajectories to GIFs). Uses OpenCV when present, PIL otherwise, each imported only when
a function runs.
"""

from __future__ import annotations

import numpy as np

from motcpp_tpu_torch.models.base import id_to_color


def plot_results(
    img: np.ndarray,
    tracks: np.ndarray,
    show_trajectories: bool = False,
    history: dict | None = None,
    thickness: int = 2,
    fontscale: float = 0.5,
    show_conf: bool = False,
    trajectory_len: int = 40,
    header: str = "",
) -> np.ndarray:
    """Draw (M, 8) track rows onto a BGR image copy.

    history: optional {track_id: [(cx, cy), ...]} updated in place when
    show_trajectories is set; trails fade and are capped at
    trajectory_len points. show_conf appends the confidence to the id
    label; header draws a banner line (tracker name / frame counter).
    """
    out = np.ascontiguousarray(img).copy()
    try:
        import cv2

        for row in np.asarray(tracks):
            x1, y1, x2, y2 = (int(v) for v in row[:4])
            tid = int(row[4])
            color = id_to_color(tid)
            cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
            label = f"{tid}" + (f" {row[5]:.2f}" if show_conf else "")
            cv2.putText(
                out,
                label,
                (x1, max(0, y1 - 4)),
                cv2.FONT_HERSHEY_SIMPLEX,
                fontscale,
                color,
                max(1, thickness - 1),
            )
            if show_trajectories and history is not None:
                pts = history.setdefault(tid, [])
                pts.append(((x1 + x2) // 2, (y1 + y2) // 2))
                del pts[:-trajectory_len]
                n = len(pts)
                for i, (a, b) in enumerate(zip(pts[:-1], pts[1:])):
                    # fade: older segments thinner/dimmer
                    f = (i + 1) / max(n - 1, 1)
                    col = tuple(int(c * (0.4 + 0.6 * f)) for c in color)
                    cv2.line(out, a, b, col, 1 + int(f * (thickness - 1)))
        if header:
            cv2.rectangle(out, (0, 0), (out.shape[1], 22), (32, 32, 32), -1)
            cv2.putText(
                out, header, (6, 16), cv2.FONT_HERSHEY_SIMPLEX,
                fontscale, (255, 255, 255), 1,
            )
        return out
    except ImportError:
        from PIL import Image, ImageDraw

        pil = Image.fromarray(out[..., ::-1])
        draw = ImageDraw.Draw(pil)
        for row in np.asarray(tracks):
            x1, y1, x2, y2 = (int(v) for v in row[:4])
            tid = int(row[4])
            b, g, r = id_to_color(tid)
            draw.rectangle([x1, y1, x2, y2], outline=(r, g, b), width=thickness)
            draw.text((x1, max(0, y1 - 12)), str(tid), fill=(r, g, b))
        return np.asarray(pil)[..., ::-1]


def make_grid(frames_by_name: dict, cols: int = 2, pad: int = 4) -> np.ndarray:
    """Tile same-sized BGR frames into a labeled comparison grid
    (the reference's multi-tracker demo layout)."""
    names = list(frames_by_name)
    h, w = frames_by_name[names[0]].shape[:2]
    rows = (len(names) + cols - 1) // cols
    canvas = np.full(
        (rows * (h + pad) + pad, cols * (w + pad) + pad, 3), 16, np.uint8
    )
    for i, name in enumerate(names):
        r, c = divmod(i, cols)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        canvas[y:y + h, x:x + w] = frames_by_name[name]
    return canvas


def save_gif(frames: list, path, fps: int = 10) -> None:
    """Write BGR frames to an animated GIF (PIL)."""
    from PIL import Image

    imgs = [Image.fromarray(np.asarray(f)[..., ::-1]) for f in frames]
    if not imgs:
        return
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )
