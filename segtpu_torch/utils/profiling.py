"""Step timing (counterpart: segtpu/utils/profiling.py).

``StepTimer`` keeps steady-state step time and items/s, skipping
warm-up steps; ``hard_sync`` waits for the device work behind a value.
CUDA launches return before the card finishes, so a host clock around a
step measures its enqueue unless the step ends in ``hard_sync``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def hard_sync(x) -> float:
    """Wait for the tensors of ``x`` (a tensor or nested dicts, lists and
    tuples of them): ``torch.cuda.synchronize`` on each CUDA device they
    lie on. Returns their f32 checksum."""
    leaves = list(_leaves(x))
    for dev in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return float(sum(t.detach().float().sum().item() for t in leaves))


class StepTimer:
    """Steady-state step timing with warm-up skipping.

    >>> t = StepTimer(warmup=2)
    >>> for batch in loader:
    ...     with t.step(n_items=batch_size):
    ...         out = train_step(...)
    ...         hard_sync(out)
    >>> t.items_per_sec
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._seen = 0
        self._time = 0.0
        self._items = 0
        self._steps = 0

    @contextlib.contextmanager
    def step(self, n_items: int = 1):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self._time += dt
            self._items += n_items
            self._steps += 1

    @property
    def items_per_sec(self) -> Optional[float]:
        return self._items / self._time if self._time > 0 else None
