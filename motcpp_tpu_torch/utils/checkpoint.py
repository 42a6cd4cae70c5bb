"""Tracker-state checkpoint files.

Counterpart of ``motcpp_tpu/utils/checkpoint.py``. The reference keeps
tracker state in memory only (reference: src/tracker.cpp:48-56). Every
tracker state here is a NamedTuple of tensors, so a checkpoint is its
fields, written in one of two formats:

  * ``.npz``: ``leaf_{i}`` numpy arrays in the order of the state's
    fields, the JAX package's layout. The port's state types have the
    JAX package's fields in its order and with its dtypes, so a file
    written by either package loads in the other.
  * any other suffix: one file of ``torch.save`` of a ``{field: CPU
    tensor}`` dict, read with ``torch.load(..., weights_only=True)``
    (in place of the JAX package's orbax directory; no class is
    pickled).

:func:`load_state` checks the file against a template state (field
count or names, and each field's shape and dtype) and raises
``ValueError`` on a mismatch; the fields land on the template's device.
A file saved from the card loads on the CPU and the other way round.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _cpu(field) -> torch.Tensor:
    if isinstance(field, torch.Tensor):
        return field.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(field))


def save_state(state, path) -> None:
    """Save a tracker state (a NamedTuple of tensors or numpy arrays).
    ``.npz`` suffix -> the JAX package's layout; otherwise a torch
    file."""
    path = Path(path)
    fields = [_cpu(f) for f in state]
    if path.suffix == ".npz":
        np.savez(path, **{f"leaf_{i}": f.numpy()
                          for i, f in enumerate(fields)})
        return
    torch.save(dict(zip(state._fields, fields)), path)


def load_state(template, path):
    """Restore a state saved with :func:`save_state` (or by the JAX
    package's ``save_state`` to ``.npz``). ``template`` is any state with
    the target structure (for example ``init_fn(S)``); the result has its
    type, and each field its device and dtype."""
    path = Path(path)
    names = template._fields
    if path.suffix == ".npz":
        with np.load(path) as data:
            if sorted(data.files) != sorted(f"leaf_{i}"
                                            for i in range(len(names))):
                raise ValueError(
                    f"state structure mismatch: {path.name} holds "
                    f"{len(data.files)} fields, {type(template).__name__} "
                    f"has {len(names)}")
            fields = [torch.from_numpy(data[f"leaf_{i}"])
                      for i in range(len(names))]
    else:
        data = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(data, dict) or list(data) != list(names):
            raise ValueError(
                f"state structure mismatch: {path.name} holds fields "
                f"{list(data) if isinstance(data, dict) else type(data)}, "
                f"{type(template).__name__} has {list(names)}")
        fields = list(data.values())
    out = []
    for name, t, f in zip(names, template, fields):
        t = torch.as_tensor(t)
        if tuple(f.shape) != tuple(t.shape) or f.dtype != t.dtype:
            raise ValueError(
                f"state mismatch in {name}: the file holds {f.dtype} "
                f"{tuple(f.shape)}, the template {t.dtype} {tuple(t.shape)}")
        out.append(f.to(t.device))
    return type(template)(*out)


def save_tracker(tracker, path) -> None:
    """Checkpoint a host-facing tracker's live state."""
    if tracker._state is None:
        raise ValueError("tracker has no state yet (no update() calls)")
    save_state(tracker._state, path)


def load_tracker(tracker, path) -> None:
    """Restore a host-facing tracker's live state in place."""
    template = (tracker._state if tracker._state is not None
                else tracker._init_state())
    tracker._state = load_state(template, path)
