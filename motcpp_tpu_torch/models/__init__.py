"""Tracker registry: ``registry`` maps tracker names to wrapper classes.

Counterpart of ``motcpp_tpu/models/__init__.py``. Only ByteTrack is
ported so far.
"""

registry: dict = {}


def register(name: str):
    def deco(cls):
        registry[name] = cls
        return cls

    return deco


def _load_all():
    """Import the ported tracker modules so the registry is filled."""
    from motcpp_tpu_torch.models import bytetrack  # noqa: F401
