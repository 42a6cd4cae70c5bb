"""Timing and inputs shared by the scoreboard (``motcpp_tpu_torch/bench.py``)
and ``chip_smoke.py``.

:func:`timed_runs` is the one timing protocol of both: one warm-up and
``repeats`` timed ``run()`` calls of a :class:`MultiStreamRunner`, the
device synchronised around each, each run's kernel launches checked.
``chip_smoke.py`` resets the runner before each run; the scoreboard does
not (``reset=False``): its steady state carries the tracker state from
the warm-up through the repeats, continuous streaming, as the JAX
package's ``bench.py::_time_rollout``. The two protocols do not give the
same measurement. :func:`rolled_crops` makes the live-ReID frames of
``bench.py::bench_livereid``: one frame of uint8 crops rolled along the
stream axis, a frame a roll.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class CheckFailure(Exception):
    """A run gave what its caller's checks refuse (a launch count)."""


def synchronize(device):
    """Waits for ``device``'s queued work when it is a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_runs(runner, dets, masks, counters=(), want=None, label="run",
               repeats=3, reset=True, **legs):
    """One warm-up and ``repeats`` timed run()s of ``runner`` over dets,
    masks and the run() keywords ``legs``, the runner's device
    synchronised before and after each run. With ``reset`` each run
    starts from a reset state; without it the state carries from the
    warm-up through the repeats. Each run's launches of the kernel
    wrapper modules ``counters`` (each with a ``LAUNCHES`` count) must
    equal ``want`` ({module: count}) where ``want`` is given, else
    :class:`CheckFailure` is raised. Returns the median seconds of a
    timed run, the timed runs' seconds, and the warm-up's and the last
    run's outputs, each (outs, out_masks)."""
    times, first = [], None
    for rep in range(1 + repeats):
        if reset:
            runner.reset()
        before = {m: m.LAUNCHES for m in counters}
        synchronize(runner.device)
        t0 = time.perf_counter()
        outs, out_masks = runner.run(dets, masks, **legs)
        synchronize(runner.device)
        if rep:
            times.append(time.perf_counter() - t0)
        else:
            first = (outs, out_masks)
        for m in counters if want is not None else ():
            got = m.LAUNCHES - before[m]
            if got != want[m]:
                raise CheckFailure(f"{label} run {rep}: {got} {m.__name__} "
                                   f"launches, want {want[m]}")
    return float(np.median(times)), times, first, (outs, out_masks)


def rolled_crops(crops0, T):
    """(T, S, ...) frames of crops from one frame ``crops0`` (S, ...):
    frame t is ``crops0`` rolled t places along the stream axis, so that
    frames differ while one frame is drawn (``bench.py:430-441``)."""
    return torch.stack([torch.roll(crops0, t, 0) for t in range(T)])
