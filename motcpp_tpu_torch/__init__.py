"""motcpp_tpu_torch: the PyTorch and CUDA port of motcpp_tpu.

The trackers are step functions over fixed-capacity slot state with a
leading stream dimension; the hot kernels are written by hand for the
NVIDIA H100 (``csrc/``), each beside a plain PyTorch version that the
CPU path runs. Entry points take ``device`` and default to ``"cuda"``.

So far ByteTrack, its host wrapper, the eval CLI and the single-device
multi-stream runner are ported; the other trackers are not yet.
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
    """Construct a tracker by name (``device`` defaults to ``"cuda"``).

    Raises ValueError for an unknown name and for a tracker that is not
    ported yet.
    """
    from motcpp_tpu_torch import models

    models._load_all()
    key = name.lower().replace("-", "").replace("_", "")
    if key not in models.registry:
        if key in TRACKERS:
            raise ValueError(
                f"Tracker '{name}' is not ported yet. "
                f"Available: {sorted(models.registry)}"
            )
        raise ValueError(
            f"Unknown tracker '{name}'. Available: {sorted(models.registry)}"
        )
    return models.registry[key](**kwargs)
