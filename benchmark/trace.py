"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over short
windows, reduced to what the per-layer metrics and the result line read.

Two windows, one after the other. The first records the card's activity
alone (CUPTI), which barely slows the host: a training step issues some
6000 launches, and recording every host operator as well slows its host
by half or more, so the card would read idle for the profiler's sake.
``Trace.summary()`` of it gives the window's length (host clock, from a
synchronize at its start to one at its end), the seconds in which some
kernel, copy or set ran on the card (the union of their intervals, which
all lie inside the window) and every device operation's total by name.
The second records the host's operators too; ``Trace.gaps()`` of it
names the longest idle gaps on the card by the innermost host event (an
operator, a runtime call or one of the harness's ``record_function``
ranges) that was running at the gap's middle. Its gaps are the profiled
host's, which is slower than the untraced one.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["Trace", "record_function"]


def _attr(e, name):
    v = getattr(e, name)
    return v() if callable(v) else v


def _merged(spans: List[Tuple[int, int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """``with Trace(device) as tr: ...`` profiles the block: the card's
    activity alone, or with ``host=True`` the host's operators too (on
    the CPU there is nothing else to record)."""

    def __init__(self, device, *, host: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.host = host or not self.cuda
        acts = [ProfilerActivity.CUDA] if self.cuda else []
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        if self.host:
            with record_function("bench.trace_start"):
                pass
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.host:
            with record_function("bench.trace_end"):
                pass
        self.prof.__exit__(*exc)
        return False

    def _events(self):
        dev, host = [], []
        start = end = None
        for e in self.prof.profiler.kineto_results.events():
            name = _attr(e, "name")
            t0 = _attr(e, "start_ns")
            t1 = t0 + _attr(e, "duration_ns")
            if name == "bench.trace_start":
                start = t0
            elif name == "bench.trace_end":
                end = t1
            is_dev = _attr(e, "device_type") == torch.autograd.DeviceType.CUDA
            if is_dev and name.startswith("bench."):
                continue      # the harness's ranges, mirrored on the card
            (dev if is_dev else host).append((t0, t1, name))
        return dev, host, start, end

    def summary(self) -> Dict:
        dev, _, _, _ = self._events()
        by_name: Dict[str, float] = defaultdict(float)
        for t0, t1, name in dev:
            by_name[name] += (t1 - t0) / 1e9
        busy_ns = sum(b - a for a, b in _merged([(t0, t1)
                                                 for t0, t1, _ in dev]))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        return {"window_s": self.t1 - self.t0, "busy_s": busy_ns / 1e9,
                "device_ops": [[n, s] for n, s in ops]}

    def gaps(self, top: int = 10) -> List[list]:
        """The ``top`` longest idle gaps on the card inside the window,
        each [the host event at its middle, seconds]."""
        dev, host, start, end = self._events()
        if start is None or end is None:
            raise RuntimeError("the trace lost its bracketing ranges")
        merged = _merged([(max(t0, start), min(t1, end))
                          for t0, t1, _ in dev if min(t1, end) > max(t0, start)])
        gaps, cursor = [], start
        for a, b in merged:
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if end > cursor:
            gaps.append((cursor, end))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:top]:
            mid = (a + b) // 2
            inside = [(t1 - t0, name) for t0, t1, name in host
                      if t0 <= mid <= t1 and not name.startswith("bench.trace")]
            named.append([min(inside)[1] if inside else "host: no event",
                          (b - a) / 1e9])
        return named

    @staticmethod
    def breakdown(summary: Dict, gaps: List[list], top: int = 10) -> Dict:
        return {"device_ops": summary["device_ops"][:top],
                "idle_gaps": gaps[:top]}
