"""The stream axis over devices, and emission counts gathered across it.

Counterpart of ``motcpp_tpu/parallel/collectives.py``. Where the JAX
package lays the stream axis over a ``Mesh(("streams",))`` and reduces
under ``shard_map`` with ``psum``, ``pmax`` and a tiled ``all_gather``,
the port holds a :class:`Mesh` (an ordered tuple of torch devices, one
shard of streams on each) in one process: each shard is reduced on its
own device, and the per-shard results are combined on the first device.
Tracking itself needs no communication (streams are independent); only
these fleet-level counts cross devices.

A mesh may name one device more than once: torch has one CPU device, and
the tests (and one card) run several shards on it.
"""

from __future__ import annotations

import numpy as np
import torch

from motcpp_tpu_torch.device import canonical_device


class Mesh(tuple):
    """The devices of the stream axis, in order: shard i of the streams
    lives on ``mesh[i]``. Built from device names or ``torch.device``s,
    each made canonical (``"cuda"`` and ``"cuda:0"`` are one device); a
    device that is not there raises."""

    def __new__(cls, devices):
        devs = tuple(canonical_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return super().__new__(cls, devs)

    def shard_size(self, n: int, what: str = "n_streams") -> int:
        """``n // len(self)``, or ValueError if ``n`` does not divide."""
        if n % len(self):
            raise ValueError(f"{what}={n} must divide evenly over "
                             f"{len(self)} devices")
        return n // len(self)


def resolve_mesh(device, devices) -> Mesh:
    """The mesh of an entry point given both ``device`` and ``devices``:
    ``device`` must be left at its default (``"cuda"``) or name
    ``devices[0]``, or ValueError."""
    mesh = Mesh(devices)
    if device != "cuda" and canonical_device(device) != mesh[0]:
        raise ValueError(
            f"device={device!r} contradicts devices[0]={mesh[0]}: leave "
            "device at its default or name the first of devices")
    return mesh


def _chunk(x, mesh: Mesh, axis: int):
    """``x`` (a tensor anywhere, or a host array) split along ``axis`` into
    len(mesh) contiguous chunks, chunk i on ``mesh[i]``."""
    n = mesh.shard_size(x.shape[axis])
    out = []
    for i, dev in enumerate(mesh):
        if isinstance(x, torch.Tensor):
            part = x.narrow(axis, i * n, n).to(dev).contiguous()
        else:
            part = torch.from_numpy(np.ascontiguousarray(
                np.take(x, range(i * n, (i + 1) * n), axis=axis))).to(dev)
        out.append(part)
    return out


def shard_over_streams(mesh: Mesh, arr, t_leading: bool = True):
    """The per-device chunks of ``arr`` along its stream axis ((T, S, ...)
    when ``t_leading``, else (S, ...)): a list with chunk i on
    ``mesh[i]``. ``arr`` may be on the host or on any device."""
    return _chunk(arr, mesh, 1 if t_leading else 0)


def _chunks(out_masks, mesh: Mesh):
    if isinstance(out_masks, (list, tuple)):
        if len(out_masks) != len(mesh):
            raise ValueError(f"{len(out_masks)} chunks for a mesh of "
                             f"{len(mesh)} devices")
        return [torch.as_tensor(c).to(d) for c, d in zip(out_masks, mesh)]
    return shard_over_streams(mesh, out_masks)


def emission_stats(out_masks, mesh: Mesh) -> dict:
    """Global emission totals.

    out_masks: (T, S, K) bool emission masks, whole or as the per-device
    chunks of :func:`shard_over_streams`. Each chunk is reduced on its
    device; the per-chunk scalars are summed (or for the peak, maxed) on
    ``mesh[0]``, and read back once. Returns ``total_emissions``,
    ``frames_processed`` (T * S), ``active_streams`` (streams that emitted
    at least once) and ``peak_tracks_per_frame`` (the most emissions of
    any (frame, stream)), as Python ints.
    """
    parts = []
    for c in _chunks(out_masks, mesh):
        per_frame = c.sum(2, dtype=torch.int32)  # (T, S_local)
        parts.append(torch.stack([
            per_frame.sum(dtype=torch.int32),
            c.any(2).any(0).sum(dtype=torch.int32),
            per_frame.max()]).to(mesh[0]))
    local = torch.stack(parts)  # (n_dev, 3) on mesh[0]
    total, active, peak = torch.cat([local[:, :2].sum(0),
                                     local[:, 2].amax(0, keepdim=True)]
                                    ).tolist()
    chunks = out_masks if isinstance(out_masks, (list, tuple)) \
        else [out_masks]
    T = chunks[0].shape[0]
    S = sum(c.shape[1] for c in chunks)
    return {
        "total_emissions": int(total),
        "frames_processed": int(T * S),
        "active_streams": int(active),
        "peak_tracks_per_frame": int(peak),
    }


def per_stream_emissions(out_masks, mesh: Mesh) -> torch.Tensor:
    """(S,) int32 emissions per stream on ``mesh[0]``: each chunk's
    (S_local,) counts reduced over (T, K) on its device, then concatenated
    in stream order (the tiled ``all_gather`` of the JAX package)."""
    return torch.cat([c.sum((0, 2), dtype=torch.int32).to(mesh[0])
                      for c in _chunks(out_masks, mesh)])
