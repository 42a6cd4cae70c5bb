"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. A CUDA
device that is not there is an error, never a quiet move to the CPU:
callers that want the CPU say so with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' (or --cpu) to run on the CPU"
        )
    return dev
