"""MOT17 dataset indexing and detection loading.

A copy of ``motcpp_tpu/data/mot17.py`` (the port imports nothing of the
JAX package); detections and embeddings are parsed by the native IO
library (``utils/native_io.py``) where it builds, in Python otherwise,
with identical arrays. Host-side equivalent of the reference loader
(reference: src/data/mot17_dataset.cpp:12-345): indexes
``<root>/<seq>/{img1, det/det.txt, gt/gt.txt, seqinfo.ini}``, reads fps
from seqinfo, loads detections in both supported formats (autodetected
per file):

  * comma MOT rows ``frame,-1,x,y,w,h,conf[,cls]`` -> tlwh converted
    to xyxy (mot17_dataset.cpp:176-209)
  * space-separated pre-generated rows ``frame x1 y1 x2 y2 conf cls``
    (mot17_dataset.cpp:210-237)
"""

from __future__ import annotations

import configparser
import dataclasses
import re
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class SequenceInfo:
    name: str
    seq_dir: Path
    img_dir: Path
    det_path: Path
    gt_path: Path
    frame_ids: list
    frame_paths: list
    fps: int = 30


class MOT17Dataset:
    """Indexes MOT17-style sequence directories.

    Args mirror the reference ctor (mot17_dataset.cpp:12-30):
        mot_root: dataset split dir (e.g. .../MOT17-mini/train)
        det_emb_root: optional pre-generated det/emb root
        model_name: detector folder under det_emb_root (e.g. yolox_x)
        reid_name: embedding model folder (used by emb_path_for)
    """

    def __init__(self, mot_root, det_emb_root: str = "", model_name: str = "",
                 reid_name: str = ""):
        self.mot_root = Path(mot_root)
        self.reid_name = reid_name
        self.det_path = None
        self.emb_root = None
        if det_emb_root and model_name:
            base = Path(det_emb_root)
            if (base / "dets").exists():
                self.det_path = base / "dets"
                self.emb_root = base / "embs"
            else:
                self.det_path = base / model_name / "dets"
                self.emb_root = base / model_name / "embs"
        self.sequences: list[SequenceInfo] = []
        self._index_sequences()

    def _index_sequences(self):
        if not self.mot_root.exists():
            raise FileNotFoundError(
                f"MOT root directory does not exist: {self.mot_root}"
            )
        for entry in sorted(self.mot_root.iterdir()):
            if not entry.is_dir():
                continue
            img_dir = entry / "img1"
            if not img_dir.exists():
                continue
            frames = []
            for p in img_dir.iterdir():
                if p.suffix in (".jpg", ".png"):
                    try:
                        frames.append((int(p.stem), p))
                    except ValueError:
                        continue
            frames.sort()
            self.sequences.append(
                SequenceInfo(
                    name=entry.name,
                    seq_dir=entry,
                    img_dir=img_dir,
                    det_path=self._resolve_det_path(entry.name, entry),
                    gt_path=entry / "gt" / "gt.txt",
                    frame_ids=[f for f, _ in frames],
                    frame_paths=[p for _, p in frames],
                    fps=self._read_seq_fps(entry),
                )
            )
        self.sequences.sort(key=lambda s: s.name)

    def _resolve_det_path(self, seq_name: str, seq_dir: Path) -> Path:
        if self.det_path is None:
            return seq_dir / "det" / "det.txt"
        # "MOT17-02-FRCNN" -> "MOT17-02.txt" (mot17_dataset.cpp:49-66)
        if seq_name.count("-") >= 2:
            candidate = self.det_path / f"MOT17-{seq_name.split('-')[1]}.txt"
            if candidate.exists():
                return candidate
        return self.det_path / f"{seq_name}.txt"

    def emb_path_for(self, seq_name: str) -> Path | None:
        """Embedding file path for a sequence, mirroring the det-name
        mapping with the reid model folder layout."""
        if self.emb_root is None:
            return None
        parts = seq_name.split("-")
        names = []
        if len(parts) >= 2:
            names.append(f"MOT17-{parts[1]}.txt")
        names.append(f"{seq_name}.txt")
        roots = [self.emb_root]
        if self.reid_name:
            roots.insert(0, self.emb_root / self.reid_name)
        for root in roots:
            for nm in names:
                p = root / nm
                if p.exists():
                    return p
        return None

    @staticmethod
    def _read_seq_fps(seq_dir: Path) -> int:
        ini = seq_dir / "seqinfo.ini"
        if not ini.exists():
            return 30
        try:
            cp = configparser.ConfigParser()
            cp.read(ini)
            for section in cp.sections():
                if cp.has_option(section, "frameRate"):
                    return cp.getint(section, "frameRate")
        except configparser.Error:
            m = re.search(r"frameRate\s*=\s*(\d+)", ini.read_text())
            if m:
                return int(m.group(1))
        return 30

    # ------------------------------------------------------------- query
    def sequence_names(self):
        return [s.name for s in self.sequences]

    def get_sequence_info(self, name: str) -> SequenceInfo:
        for s in self.sequences:
            if s.name == name:
                return s
        raise KeyError(f"Sequence not found: {name}")

    # ------------------------------------------------------------ loads
    @staticmethod
    def load_detections(det_path) -> dict[int, np.ndarray]:
        """frame_id -> (n, 6) [x1,y1,x2,y2,conf,cls] float32, parsed by
        the native IO library (utils/native_io.py), else in Python."""
        det_path = Path(det_path)
        if not det_path.exists():
            return {}
        try:
            from motcpp_tpu_torch.utils.native_io import parse_detections

            rows = parse_detections(str(det_path))
        except Exception:
            rows = _parse_det_text(det_path)
        out: dict[int, list] = {}
        for frame_id, det in rows:
            out.setdefault(frame_id, []).append(det)
        return {
            f: np.asarray(v, np.float32).reshape(len(v), 6)
            for f, v in out.items()
        }

    @staticmethod
    def load_embeddings(emb_path, detections: dict) -> dict[int, np.ndarray]:
        """One embedding row per detection, in ascending frame order
        (mot17_dataset.cpp:243-294)."""
        emb_path = Path(emb_path) if emb_path else None
        if emb_path is None or not emb_path.exists():
            return {}
        det_frame_map = []
        for frame_id in sorted(detections):
            det_frame_map += [frame_id] * detections[frame_id].shape[0]
        try:
            from motcpp_tpu_torch.utils import native_io

            embs = native_io.parse_embeddings(emb_path)
        except Exception:
            try:
                embs = np.loadtxt(emb_path, dtype=np.float32, ndmin=2)
            except ValueError:
                return {}
        out: dict[int, list] = {}
        for idx in range(min(len(det_frame_map), embs.shape[0])):
            out.setdefault(det_frame_map[idx], []).append(embs[idx])
        return {f: np.stack(v) for f, v in out.items()}

    def get_frame(self, seq_info: SequenceInfo, frame_id: int,
                  detections: dict, embeddings: dict):
        """(image | None, dets (n, 6), embs (n, E)); the image is None
        where the sequence has no such frame or no image reader is
        installed."""
        img = None
        if frame_id in seq_info.frame_ids:
            idx = seq_info.frame_ids.index(frame_id)
            img = imread(seq_info.frame_paths[idx])
        dets = detections.get(frame_id, np.zeros((0, 6), np.float32))
        embs = embeddings.get(
            frame_id, np.zeros((dets.shape[0], 0), np.float32)
        )
        return img, dets, embs


def imread(path):
    """BGR uint8 image with cv2, else PIL, else None (the caller then
    uses the reference eval's dummy frame)."""
    try:
        import cv2

        return cv2.imread(str(path))
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        return None
    return np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1]


def _parse_det_text(det_path: Path):
    """Rows of (frame_id, [x1, y1, x2, y2, conf, cls]); the format is
    detected per file (mot17_dataset.cpp:159-167)."""
    rows = []
    with open(det_path) as f:
        first = True
        comma = False
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if first:
                comma = "," in line
                first = False
            if comma:
                vals = []
                for tok in line.split(","):
                    try:
                        vals.append(float(tok))
                    except ValueError:
                        break
                if len(vals) < 7:
                    continue
                # float32 values and float32 sums, as the JAX package's
                # native parser (native/motcpp_io.cpp: strtof) gives them
                x1, y1, w, h, conf = (np.float32(v) for v in vals[2:7])
                cls = vals[7] if len(vals) > 7 else 0.0
                rows.append((int(vals[0]), [x1, y1, x1 + w, y1 + h, conf, cls]))
            else:
                vals = [float(t) for t in line.split()]
                if len(vals) < 7:
                    continue
                rows.append((int(vals[0]), vals[1:7]))
    return rows


def read_gt_max_frame(gt_path) -> int:
    """Max frame id in a gt.txt (for ablation-offset detection,
    tools/motcpp_eval.cpp:338-351)."""
    gt_path = Path(gt_path)
    if not gt_path.exists():
        return 0
    mx = 0
    with open(gt_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                mx = max(mx, int(float(line.split(",")[0])))
            except ValueError:
                continue
    return mx
