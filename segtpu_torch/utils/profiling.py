"""Tracing, step timing and NaN checks (counterpart:
segtpu/utils/profiling.py).

``trace(logdir)`` writes a ``torch.profiler`` trace of a block;
``StepTimer`` keeps steady-state step time and items/s, skipping
warm-up steps; ``hard_sync`` waits for the device work behind a value.
CUDA launches return before the card finishes, so a host clock around a
step measures its enqueue unless the step ends in ``hard_sync``.
``debug_mode()`` raises on a NaN made inside a block.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (host, and the card's
    kernels where CUDA is available), written at its end as
    ``<logdir>/trace.json`` in Chrome's trace format (Perfetto or
    chrome://tracing open it). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class _NanCheck(TorchFunctionMode):
    """Raises ``FloatingPointError`` when a torch function called from
    Python returns a floating tensor that holds a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_mode():
    """Raise ``FloatingPointError`` on a NaN made inside the block, as
    ``jax_debug_nans`` does in the JAX package. It covers the forward
    and the backward: every torch function the block calls from Python
    (modules' operations included) has its floating outputs checked, and
    ``torch.autograd.detect_anomaly(check_nan=True)`` checks every
    backward function's outputs (its ``RuntimeError`` is raised again
    as ``FloatingPointError``). It does not see inside a hand-written
    kernel's launch (a ctypes call writes into a tensor made before it):
    the first torch function that reads a NaN it wrote shows it. Each
    check waits for the device, so the block runs at the host's pace."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True), _NanCheck():
            yield
    except RuntimeError as e:
        if "returned nan values" not in str(e):
            raise
        raise FloatingPointError(str(e)) from e


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
    >>> t.steps_per_sec, t.items_per_sec
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
    def steps_per_sec(self) -> Optional[float]:
        return self._steps / self._time if self._time > 0 else None

    @property
    def items_per_sec(self) -> Optional[float]:
        return self._items / self._time if self._time > 0 else None

    @property
    def sec_per_step(self) -> Optional[float]:
        return self._time / self._steps if self._steps else None
