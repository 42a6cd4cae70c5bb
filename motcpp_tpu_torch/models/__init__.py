"""Tracker registry: ``registry`` maps tracker names to wrapper classes.

Counterpart of ``motcpp_tpu/models/__init__.py``: all nine trackers
(SORT, ByteTrack, OC-SORT, DeepOC-SORT, StrongSORT, BoT-SORT,
BoostTrack, HybridSORT and UCMCTrack). ``per_class.PerClassTracker``
wraps any of them to track each class on its own.
"""

registry: dict = {}


def register(name: str):
    def deco(cls):
        registry[name] = cls
        return cls

    return deco


def _load_all():
    """Import the ported tracker modules so the registry is filled."""
    from motcpp_tpu_torch.models import (  # noqa: F401
        boosttrack,
        botsort,
        bytetrack,
        deepocsort,
        hybridsort,
        ocsort,
        sort,
        strongsort,
        ucmctrack,
    )
