"""Data: MOT17 loading, MOT-Challenge output, synthetic multi-stream
detections, the live camera-motion frames and the deterministic
scenes. Copies of the JAX package's modules, so that
the port imports nothing of it."""

from motcpp_tpu_torch.data.mot17 import MOT17Dataset, SequenceInfo, read_gt_max_frame
from motcpp_tpu_torch.data.mot_format import convert_to_mot_format, write_mot_results
from motcpp_tpu_torch.data.synthetic import (
    ablation_scene,
    camera_pan_scene,
    obb_stream_dets,
    pack_valid_rows,
    pan_frames,
    pan_texture,
    synth_stream_dets,
)

__all__ = [
    "MOT17Dataset",
    "SequenceInfo",
    "ablation_scene",
    "camera_pan_scene",
    "convert_to_mot_format",
    "obb_stream_dets",
    "pack_valid_rows",
    "pan_frames",
    "pan_texture",
    "read_gt_max_frame",
    "synth_stream_dets",
    "write_mot_results",
]
