"""Per-layer measurements that the readers in ``benchmark/metrics/``
share: a layer's device time by CUDA events around the benchmark's own
calls into its entry point, at the cell's shape, and the shares built on
it. Each result is computed once a run (``run.layer_cache``).
A layer's device time is read from replays of a CUDA graph of the
benchmark's call into it.

Served layers and their entry points (the engine's own call order,
``engine.Segmenter._run``, on the ring's first batch):

* ``front``: ``kernels.front.normalize_s2d_front``;
* ``encoder``: the engine's folded encoder (``models/fast_encoder.py``);
* ``decoder``: the engine's folded decoder (``models/fast_decoder.py``);
* ``tail``: ``kernels.upsample_argmax.upsample_argmax`` (H first) or
  ``upsample_argmax_flat`` (W first), as the engine picks.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from benchmark.counts.work import padded, served_flop, served_layers
from benchmark.peaks import BF16_FLOP_PER_S, least_seconds

REPS = 20
WARMUP = 3


def cache(run) -> dict:
    if not hasattr(run, "layer_cache"):
        run.layer_cache = {}
    return run.layer_cache


def graphed(fn):
    """``fn``'s launches captured once as a CUDA graph (after one eager
    call, which makes the plans and tables), returned as its replay: a
    layer timed from its replays reads the card's time, not the host's
    pace of issuing its launches (a front call's Python outlasts its
    0.07 ms kernel)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.collect()                  # no graph destroyed mid-capture
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        gc.enable()
    return graph.replay


def device_seconds(run, fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Seconds a call of ``fn`` takes on the card: CUDA events around
    ``reps`` replays of its graph after ``warmup``."""
    fn = graphed(fn)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(run.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def served_calls(run) -> dict:
    """{layer: zero-argument call} on the ring's first batch."""
    c = cache(run)
    if "calls" in c:
        return c["calls"]
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.kernels.upsample_argmax import (flat_tail_profitable,
                                                      upsample_argmax,
                                                      upsample_argmax_flat)
    seg = run.seg
    imgs = run.frames[0]
    n, h, w, _ = imgs.shape
    hp, wp = padded(h, w)
    ac = seg.align_corners

    def front():
        return normalize_s2d_front(imgs, padded_hw=(hp, wp),
                                   out_dtype=seg.compute_dtype)

    with torch.inference_mode():
        x12 = front().contiguous()
        taps = seg.encoder(x12)
        logits = seg.decoder(taps, align_corners=ac)
    lh, lw = logits.shape[-2:]

    def tail():
        if flat_tail_profitable(lw):
            return upsample_argmax_flat(
                logits.reshape(n, logits.shape[1], lh * lw), (lh, lw),
                (hp, wp), crop_hw=(h, w), align_corners=ac)
        return upsample_argmax(logits, (hp, wp), crop_hw=(h, w),
                               align_corners=ac)

    c["calls"] = {"front": front,
                  "encoder": lambda: seg.encoder(x12),
                  "decoder": lambda: seg.decoder(taps, align_corners=ac),
                  "tail": tail}
    return c["calls"]


def roofline_pct(run, layer: str):
    """100 x the layer's least time (``counts``, ``peaks``) over its
    device time, at the ring's batch shape; None off the card."""
    if not run.cuda():
        return None
    fn = served_calls(run)[layer]
    with torch.inference_mode():
        seconds = device_seconds(run, fn)
    n, h, w, _ = run.frames[0].shape
    work = served_layers(run.cfg, n, h, w)[layer]
    return 100.0 * least_seconds(work["flop"], work["bytes"]) / seconds


def idle_pct(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def serve_mfu(run):
    """100 x the window's FLOPs (forward, benchmark counts) over the
    window's seconds at the bf16 peak."""
    t = run.traffic
    flop = served_flop(run.cfg, int(t["height"]), int(t["width"]))
    return 100.0 * flop * run.window_frames / (run.window_s
                                               * BF16_FLOP_PER_S)


def enqueue_ms(run, reps: int = REPS):
    """Host ms from a ``predict_batch`` call's start to its return, the
    card idle at each start, averaged over ``reps`` calls."""
    if not run.cuda():
        return None
    times = []
    for i in range(reps + WARMUP):
        torch.cuda.synchronize(run.device)
        t0 = time.perf_counter()
        run.seg.predict_batch(run.frames[i % len(run.frames)])
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize(run.device)
    return 1e3 * statistics.fmean(times[WARMUP:])


def train_parts_ms(run, steps: int = 6, skip: int = 2) -> dict:
    """{"forward", "update"}: device ms a step (CUDA events) of the step's
    ``parts.terms`` with the loss, and of its ``parts.update``, over
    ``steps`` steps of the run's own state on its ring, the first
    ``skip`` left out."""
    c = cache(run)
    if "train_parts" in c:
        return c["train_parts"]
    if not run.cuda():
        return None
    from segtpu_torch.engine.trainer import combine_loss_terms
    parts = run.step.parts
    model = run.state.model
    model.train()
    ring = len(run.batches)
    marks = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        batch = run.batches[run.next_batch % ring]
        run.next_batch += 1
        ev[0].record()
        loss = combine_loss_terms([parts.terms(model, batch, run.device)],
                                  run.device)
        ev[1].record()
        run.state = parts.update(run.state, loss)
        ev[2].record()
        marks.append(ev)
    torch.cuda.synchronize(run.device)
    marks = marks[skip:]
    c["train_parts"] = {
        "forward": statistics.fmean(a.elapsed_time(b) for a, b, _ in marks),
        "update": statistics.fmean(b.elapsed_time(e) for _, b, e in marks)}
    return c["train_parts"]
