"""Per-layer readings from the program's own spans and counters, which the
readers in ``benchmark/metrics/`` share: the program's
``utils/profiling.py`` ``tracing()`` turned on around the benchmark's own
calls, after the traced windows (which run with it off), and the spans
``collect()`` returns grouped by request. Each result is computed once a
run (``layers.cache``). A program without the recorder, or off the card,
reads None.

Serving (``served``): ``REPS`` calls of ``predict_batch`` on the ring
after ``WARMUP`` (the first captures the shape's traced program), each
issued to an idle card as ``enqueue_ms.serve``'s are (a traced replay
first waits for the previous replay's spans). Read a call: the device
ms of the spans ``segtpu.engine.front``, ``.encoder``, ``.decoder`` and
``.tail`` (event nodes inside the replayed graph), the host ms of the
root ``segtpu.engine.predict``, and the engine's ``launches`` counter.

Training (``train``): ``STEPS`` whole steps of ``run.step`` on the run's
state and ring, back to back with the window's run-ahead (the traffic's
``depth``), the first ``SKIP`` left out. Read a step: the device ms of
``segtpu.train.forward``, of its ``segtpu.train.bn`` children summed,
of ``.loss``, ``.backward``, ``.optimizer`` and ``.polyak``, and the
host ms of the root ``segtpu.train.step``.
"""

from __future__ import annotations

import statistics
from collections import defaultdict

import torch

from benchmark.layers import cache
from benchmark.served import Fence

REPS = 20
WARMUP = 3
STEPS = 6
SKIP = 2

SERVED = ("front", "encoder", "decoder", "tail")
TRAIN = ("forward", "bn", "loss", "backward", "optimizer", "polyak")


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from segtpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def by_request(spans, root: str) -> list:
    """[(root span, {name: [spans]})] for each request whose root span is
    named ``root``, in the order the roots opened; names are the spans'
    last dotted part."""
    parts = defaultdict(lambda: defaultdict(list))
    roots = []
    for s in spans:
        if s["name"] == root and s["parent"] is None:
            roots.append(s)
        parts[s["request"]][s["name"].rsplit(".", 1)[-1]].append(s)
    return [(r, parts[r["request"]]) for r in roots]


def device_ms(named: dict, part: str) -> float:
    """Device ms of the request's ``part`` spans, summed."""
    return sum(s["device_ms"] for s in named.get(part, ()))


def served(run):
    """{layer: device ms a call, "predict_host": host ms a call,
    "launches": launches a call}."""
    c = cache(run)
    if "spans_served" in c:
        return c["spans_served"]
    prof = recorder()
    if not run.cuda() or prof is None:
        return None
    seg, frames = run.seg, run.frames
    with prof.tracing():
        for i in range(WARMUP):
            seg.predict_batch(frames[i % len(frames)])
        torch.cuda.synchronize(run.device)
        prof.collect()
        launches0 = seg.launches
        for i in range(REPS):
            torch.cuda.synchronize(run.device)
            seg.predict_batch(frames[i % len(frames)])
        torch.cuda.synchronize(run.device)
        launches = (seg.launches - launches0) / REPS
        calls = by_request(prof.collect(), "segtpu.engine.predict")
    out = {part: statistics.fmean(device_ms(named, part)
                                  for _, named in calls)
           for part in SERVED}
    out["predict_host"] = statistics.fmean(r["host_ms"] for r, _ in calls)
    out["launches"] = launches
    c["spans_served"] = out
    return out


def train(run):
    """{part: device ms a step (``bn`` summed over the step's spans),
    "step_host": host ms a step}."""
    c = cache(run)
    if "spans_train" in c:
        return c["spans_train"]
    prof = recorder()
    if not run.cuda() or prof is None:
        return None
    fence = Fence(run.device, int(run.traffic["depth"]))
    ring = len(run.batches)
    with prof.tracing():
        torch.cuda.synchronize(run.device)
        prof.collect()
        for _ in range(STEPS):
            run.state, _ = run.step(run.state,
                                    run.batches[run.next_batch % ring])
            run.next_batch += 1
            fence.mark()
        torch.cuda.synchronize(run.device)
        steps = by_request(prof.collect(), "segtpu.train.step")[SKIP:]
    out = {part: statistics.fmean(device_ms(named, part)
                                  for _, named in steps)
           for part in TRAIN}
    out["step_host"] = statistics.fmean(r["host_ms"] for r, _ in steps)
    c["spans_train"] = out
    return out


def read(run, kind: str, part: str):
    """``served`` or ``train``'s reading of ``part``, or None."""
    got = {"served": served, "train": train}[kind](run)
    return None if got is None else got[part]
