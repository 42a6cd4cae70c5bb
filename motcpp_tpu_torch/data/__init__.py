"""Host-side data: MOT17 loading, MOT-Challenge output and synthetic
multi-stream detections. Copies of the JAX package's modules, so that
the port imports nothing of it."""

from motcpp_tpu_torch.data.mot17 import MOT17Dataset, SequenceInfo, read_gt_max_frame
from motcpp_tpu_torch.data.mot_format import convert_to_mot_format, write_mot_results
from motcpp_tpu_torch.data.synthetic import synth_stream_dets

__all__ = [
    "MOT17Dataset",
    "SequenceInfo",
    "convert_to_mot_format",
    "read_gt_max_frame",
    "synth_stream_dets",
    "write_mot_results",
]
