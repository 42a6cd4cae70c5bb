"""Multi-stream tracking on one device: all streams per step, a loop
over frames.

Counterpart of ``motcpp_tpu/parallel/streams.py::make_rollout`` and the
single-device ``MultiStreamRunner``. The step already takes every
stream at once (a leading S dimension), so the rollout is a Python loop
over the T frames, where the JAX package scans.
"""

from __future__ import annotations

from typing import Callable

import torch

from motcpp_tpu_torch.device import resolve_device


def make_rollout(step_fn: Callable):
    """Build ``rollout(states, dets, masks) -> (states, (outs, out_masks))``
    for a stream-batched step: dets (T, S, N, D) and masks (T, S, N) give
    outs (T, S, K, 8) and out_masks (T, S, K)."""

    def rollout(states, dets, masks):
        outs, out_masks = [], []
        for t in range(dets.shape[0]):
            states, (out, out_mask) = step_fn(states, dets[t], masks[t])
            outs.append(out)
            out_masks.append(out_mask)
        return states, (torch.stack(outs), torch.stack(out_masks))

    return rollout


def _copy(states):
    return type(states)(*(t.clone() for t in states))


class MultiStreamRunner:
    """Runs S streams through a tracker step on one device.

    Example:
        init_fn, step_fn = make_bytetrack(cfg, device="cuda")
        runner = MultiStreamRunner(init_fn, step_fn, n_streams=256)
        outs, out_masks = runner.run(dets, masks)  # (T,S,N,6), (T,S,N)

    The state carries across ``run()`` calls until ``reset()``.
    """

    def __init__(self, init_fn: Callable, step_fn: Callable, n_streams: int,
                 device="cuda"):
        self.n_streams = int(n_streams)
        self.device = resolve_device(device)
        self._init_fn = init_fn
        self._rollout = make_rollout(step_fn)
        self._states = None

    def init_states(self):
        return self._init_fn(self.n_streams)

    def run(self, dets, masks, states=None):
        """Track T frames of all streams; returns (outs, out_masks) on the
        runner's device. Without ``states`` the call continues from the
        carried state and updates it; with ``states`` it is pure and the
        carried state is left as it was."""
        dets = torch.as_tensor(dets, dtype=torch.float32, device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        if dets.dim() != 4 or dets.shape[1] != self.n_streams:
            raise ValueError(
                f"dets must be (T, {self.n_streams}, N, D), got "
                f"{tuple(dets.shape)}"
            )
        if masks.shape != dets.shape[:3]:
            raise ValueError(
                f"masks must be {tuple(dets.shape[:3])}, got "
                f"{tuple(masks.shape)}"
            )
        stateless = states is not None
        if stateless:
            states = _copy(states)
        elif self._states is not None:
            states = self._states
        else:
            states = self.init_states()
        states, outs = self._rollout(states, dets, masks)
        if not stateless:
            self._states = states
        return outs

    def set_states(self, states):
        """Install a carried state (for example one restored from a
        checkpoint); later ``run()`` calls continue from it."""
        self._states = _copy(states)

    @property
    def states(self):
        """A copy of the carried state, or None before the first run."""
        return None if self._states is None else _copy(self._states)

    def reset(self):
        self._states = None
