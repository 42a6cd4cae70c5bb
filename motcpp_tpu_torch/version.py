"""Version and feature flags.

Counterpart of ``motcpp_tpu/version.py`` (reference:
include/motcpp/version.hpp:1-24): the version, and feature flags for the
port's devices in place of the C++ build flags (MOTCPP_HAS_ONNX /
MOTCPP_HAS_OPENCV). ``has_cuda`` takes the place of the JAX package's
``has_tpu``.
"""

__version__ = "0.1.0"

VERSION_MAJOR = 0
VERSION_MINOR = 1
VERSION_PATCH = 0


def version() -> str:
    return __version__


def has_cuda() -> bool:
    """True when a CUDA device is attached (the port's entry points
    default to it)."""
    import torch

    return torch.cuda.is_available()


def has_cv2() -> bool:
    """OpenCV availability (used only by the data/visualization layer,
    never by the compute path)."""
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False
