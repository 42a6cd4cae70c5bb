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


def canonical_device(device) -> torch.device:
    """``device`` resolved as by :func:`resolve_device` and named one way:
    a CUDA device with its index (``"cuda"`` is the current device), the
    CPU without one. ``torch.device("cuda")`` and ``torch.device("cuda:0")``
    compare unequal; their canonical devices do not."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


class PerDevice:
    """A value (constants, weights) made by ``build(device)`` for each
    device that asks for it: on ``home`` at once, on any other device the
    first time it is asked for, and reused after. Devices are told apart
    by :func:`canonical_device`, so one device named two ways holds one
    copy. A tracker step or an embed function holds one of these in place
    of tensors, so that it runs on the device of its inputs."""

    def __init__(self, build, home):
        self._build = build
        self._by_device = {}
        self.on(home)

    @classmethod
    def tensors(cls, home, *tensors):
        """``tensors`` (made on ``home``), copied to each device asked for."""
        return cls(lambda dev: tuple(t.to(dev) for t in tensors), home)

    def on(self, device):
        got = self._by_device.get(device)  # a tensor's device: canonical
        if got is None:
            key = canonical_device(device)
            got = self._by_device.get(key)
            if got is None:
                got = self._by_device[key] = self._build(key)
        return got
