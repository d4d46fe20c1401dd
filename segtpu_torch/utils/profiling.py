"""Spans and counters of the program, tracing, step timing and NaN
checks (counterpart: segtpu/utils/profiling.py).

``tracing()`` is the program's one switch for its spans. While it is
on, ``span(name, request=None, device=None)`` records a host span
(name, start, end, parent span, request id) and, where ``device`` is a
CUDA device, a device span: CUDA events on the device's current stream
at entry and exit. Each host span is also a ``torch.profiler``
``record_function`` range of the same name, so a profile taken inside
``tracing()`` puts the program's spans on the clock of the card's
activity. Parents are kept per thread; a span without a parent starts
a request of its own, and a child carries its parent's request id.
Spans wait in a bounded buffer (``MAX_SPANS``, the newest kept);
``collect()`` waits for their device events and returns them. Off, a
span is one shared no-op context: no range, no event, no allocation.

Inside a CUDA graph capture (``utils.aot``) a device span's events
become event-record nodes of the graph: the capture keeps the spans
(``captured_spans``) and every replay records them anew
(``replayed``), read before the next replay re-records their events
(``resolve``).

``trace(logdir)`` writes a ``torch.profiler`` trace of a block, with
tracing on, and the block's spans beside it; ``StepTimer`` keeps
steady-state step time and items/s, skipping warm-up steps;
``hard_sync`` waits for the device work behind a value. CUDA launches
return before the card finishes, so a host clock around a step
measures its enqueue unless the step ends in ``hard_sync``.
``debug_mode()`` raises on a NaN made inside a block.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import List, Optional

import torch
from torch.overrides import TorchFunctionMode


MAX_SPANS = 65536

_on = False                   # the one check a span makes while off
_depth = 0                    # open ``tracing()`` blocks
_switch = threading.Lock()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()    # .stack: open spans; .captured: a capture's


class Span:
    """One recorded span. ``start`` and ``end`` are ``time.perf_counter()``
    seconds (None for a span a graph replay recorded, which ran no
    Python); ``events`` the CUDA events at its entry and exit, or None;
    ``device_ms`` their elapsed time once read."""

    __slots__ = ("id", "name", "request", "parent", "thread", "start",
                 "end", "events", "device_ms")

    def __init__(self, name, request, parent):
        self.id = next(_span_ids)
        self.name = name
        self.request = request
        self.parent = parent
        self.thread = threading.get_ident()
        self.start = self.end = None
        self.events = None
        self.device_ms = None

    def as_dict(self) -> dict:
        host = (None if self.start is None or self.end is None
                else 1e3 * (self.end - self.start))
        return {"id": self.id, "name": self.name, "request": self.request,
                "parent": self.parent, "thread": self.thread,
                "start_s": self.start, "host_ms": host,
                "device_ms": self.device_ms}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda_stream(device):
    """The current stream of ``device`` where it is a CUDA device whose
    events can be read later: not inside a CUDA graph capture unless the
    capture keeps its spans."""
    if device is None or torch.device(device).type != "cuda":
        return None
    if (torch.cuda.is_current_stream_capturing()
            and getattr(_local, "captured", None) is None):
        return None
    return torch.cuda.current_stream(device)


class _Open:
    """The context of one span while tracing is on."""

    __slots__ = ("name", "request", "device", "span", "range", "stream")

    def __init__(self, name, request, device):
        self.name, self.request, self.device = name, request, device

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        request = self.request
        if request is None:
            request = (parent.request if parent is not None
                       else next(_request_ids))
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        s = self.span = Span(self.name, request,
                             None if parent is None else parent.id)
        self.stream = _cuda_stream(self.device)
        if self.stream is not None:
            s.events = (torch.cuda.Event(enable_timing=True, external=True),
                        torch.cuda.Event(enable_timing=True, external=True))
            s.events[0].record(self.stream)
        captured = getattr(_local, "captured", None)
        (_spans if captured is None else captured).append(s)
        stack.append(s)
        s.start = time.perf_counter()
        return s

    def __exit__(self, *exc):
        s = self.span
        if s.events is not None:
            s.events[1].record(self.stream)
        s.end = time.perf_counter()
        _stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, request=None, device=None):
    """A context that records a span named ``name`` while tracing is on
    (see the module doc) and does nothing while it is off. ``request``:
    the id this span and its children carry (default: the parent's, or
    a new one for a span without a parent); ``device``: a CUDA device
    on whose current stream the span's device time is recorded."""
    if not _on:
        return _NO_SPAN
    return _Open(name, request, device)


def enabled() -> bool:
    """Whether tracing is on: a program whose spans become part of it (a
    CUDA graph's event nodes) names this in its key."""
    return _on


@contextlib.contextmanager
def tracing():
    """Record spans inside the block (re-entrant; the buffer keeps the
    newest ``MAX_SPANS``)."""
    global _on, _depth, _spans
    with _switch:
        if _spans.maxlen != MAX_SPANS:
            _spans = collections.deque(_spans, maxlen=MAX_SPANS)
        _depth += 1
        _on = True
    try:
        yield
    finally:
        with _switch:
            _depth -= 1
            _on = _depth > 0


@contextlib.contextmanager
def captured_spans():
    """Around a CUDA graph capture: the spans opened on this thread inside
    the block go to the yielded list, not to the buffer (their events
    are the graph's nodes, recorded by each replay: ``replayed``)."""
    prev = getattr(_local, "captured", None)
    _local.captured = out = []
    try:
        yield out
    finally:
        _local.captured = prev


def replayed(captured) -> Optional[List[Span]]:
    """After a replay of a graph whose capture kept ``captured``: a new
    span for each, in the buffer, under this thread's open span and its
    request; None while tracing is off or when nothing was kept. The
    caller ``resolve``s them before the graph's next replay."""
    if not _on or not captured:
        return None
    stack = _stack()
    parent = stack[-1] if stack else None
    request = parent.request if parent is not None else next(_request_ids)
    ids = {}
    out = []
    for c in captured:
        s = Span(c.name, request, ids.get(c.parent, None if parent is None
                                           else parent.id))
        s.events = c.events
        ids[c.id] = s.id
        _spans.append(s)
        out.append(s)
    return out


def resolve(spans) -> None:
    """Wait for the device events of ``spans`` and read their device
    milliseconds (spans still open, or without events, are left)."""
    for s in spans:
        # a replayed span (no host times) is closed once its graph ran
        closed = s.end is not None or s.start is None
        if s.events is not None and s.device_ms is None and closed:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])


def collect() -> List[dict]:
    """The buffer's spans in the order they opened, each as a dict (``id``,
    ``name``, ``request``, ``parent``, ``thread``, ``start_s``,
    ``host_ms``, ``device_ms``), after waiting for their device events;
    the buffer is emptied."""
    spans = list(_spans)
    _spans.clear()
    resolve(spans)
    return [s.as_dict() for s in sorted(spans, key=lambda s: s.id)]


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (host, and the card's
    kernels where CUDA is available), with tracing on, written at its
    end as ``<logdir>/trace.json`` in Chrome's trace format (Perfetto or
    chrome://tracing open it; the program's spans are its ``segtpu.*``
    ranges), and the spans ``collect()`` returns as
    ``<logdir>/spans.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(collect(), f)


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
