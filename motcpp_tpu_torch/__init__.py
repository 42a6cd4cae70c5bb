"""motcpp_tpu_torch: the PyTorch and CUDA port of motcpp_tpu.

The trackers are step functions over fixed-capacity slot state with a
leading stream dimension; the hot kernels are written by hand for the
NVIDIA H100 (``csrc/``), each beside a plain PyTorch version that the
CPU path runs. Entry points take ``device`` and default to ``"cuda"``.

Ported: the nine trackers with their host wrappers and the per-class
wrapper, the eval CLI, the host camera-motion estimators and the
sparse-flow and ECC ones in torch, OSNet live ReID (every OSBlock
through a CUDA kernel on the card; every frame, at a cadence or at a
priority budget), the single-device multi-stream runner with live
camera motion from frames, and the serving runtime on one device (the
native stream mux and ``serving.TrackingService``).
"""

__all__ = ["create_tracker", "TRACKERS"]

TRACKERS = (
    "sort",
    "bytetrack",
    "ocsort",
    "deepocsort",
    "strongsort",
    "botsort",
    "boosttrack",
    "hybridsort",
    "ucmctrack",
)


def create_tracker(name: str, **kwargs):
    """Construct a tracker by name (``device`` defaults to ``"cuda"``);
    ValueError for an unknown name."""
    from motcpp_tpu_torch import models

    models._load_all()
    key = name.lower().replace("-", "").replace("_", "")
    if key not in models.registry:
        raise ValueError(
            f"Unknown tracker '{name}'. Available: {sorted(models.registry)}"
        )
    return models.registry[key](**kwargs)
