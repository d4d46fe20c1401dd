"""Per-layer readings of the DeepLab-v3 cell (``serve_dlv3mnv2_city_b8``),
which the readers in ``benchmark/metrics/`` share. Each is computed once
a run (``layers.cache``); off the card, or on a program without what it
reads (a span, a counter, the folded encoder's ``atrous_from``), it reads
None.

* ``spans(run)``: the program's device spans ``segtpu.engine.encoder.
  atrous`` (the four stride-16 blocks) and ``segtpu.engine.decoder.aspp``
  (the head), event nodes of the shape's CUDA graph, each call issued to
  an idle card, mean of ``spans.REPS`` calls after ``spans.WARMUP``, as
  ``benchmark/spans.py`` reads the engine's four layers;
* ``aspp_launches(run)``: the program's ``kernels.aspp.aspp_chw.launches``
  over one eager call (``Segmenter.infer``; a graph's replay runs no
  wrapper);
* ``roofline_pct(run, part)``: 100 x the least time of ``atrous`` or
  ``head`` (``counts/dlv3.py`` at the bf16 peak and the HBM rate) over its
  device time, by CUDA events around replays of a CUDA graph of the
  benchmark's call into it (``layers.device_seconds``) on the ring's
  first batch;
* ``mfu(run)``: the window's FLOPs (``counts/dlv3.served_flop``) over its
  seconds at the bf16 peak.
"""

from __future__ import annotations

import statistics

import torch

from benchmark import spans as program_spans
from benchmark.counts.dlv3 import served_flop, served_layers
from benchmark.layers import cache, device_seconds
from benchmark.peaks import BF16_FLOP_PER_S, least_seconds

PARTS = ("atrous", "aspp")


def spans(run):
    """{"atrous": device ms a call, "aspp": device ms a call}, or None."""
    c = cache(run)
    if "spans_dlv3" in c:
        return c["spans_dlv3"]
    prof = program_spans.recorder()
    if not run.cuda() or prof is None:
        return None
    seg, frames = run.seg, run.frames
    with prof.tracing():
        for i in range(program_spans.WARMUP):
            seg.predict_batch(frames[i % len(frames)])
        torch.cuda.synchronize(run.device)
        prof.collect()
        for i in range(program_spans.REPS):
            torch.cuda.synchronize(run.device)
            seg.predict_batch(frames[i % len(frames)])
        torch.cuda.synchronize(run.device)
        calls = program_spans.by_request(prof.collect(),
                                         "segtpu.engine.predict")
    out = {part: (statistics.fmean(program_spans.device_ms(named, part)
                                   for _, named in calls)
                  if calls and all(part in named for _, named in calls)
                  else None)
           for part in PARTS}
    c["spans_dlv3"] = out
    return out


def span_ms(run, part: str):
    got = spans(run)
    return None if got is None else got[part]


def aspp_launches(run):
    """Launches of the head's kernel in one call, or None."""
    c = cache(run)
    if "aspp_launches" in c:
        return c["aspp_launches"]
    try:
        from segtpu_torch.kernels.aspp import aspp_chw
    except ImportError:
        return None
    if not run.cuda():
        return None
    n0 = aspp_chw.launches
    run.seg.infer(run.frames[0])
    torch.cuda.synchronize(run.device)
    c["aspp_launches"] = aspp_chw.launches - n0
    return c["aspp_launches"]


def calls(run):
    """{"atrous": the four stride-16 blocks on their input, "head": the
    folded head on the encoder's taps}, zero-argument calls on the ring's
    first batch, or None."""
    c = cache(run)
    if "dlv3_calls" in c:
        return c["dlv3_calls"]
    from segtpu_torch.kernels.front import normalize_s2d_front
    from benchmark.counts.dlv3 import padded
    seg = run.seg
    enc = seg.encoder
    k = getattr(enc, "atrous_from", None)
    if k is None or k >= len(enc.blocks):
        return None
    imgs = run.frames[0]
    _, h, w, _ = imgs.shape
    with torch.inference_mode():
        x12 = normalize_s2d_front(imgs, padded_hw=padded(h, w),
                                  out_dtype=seg.compute_dtype).contiguous()
        taps = enc(x12)
        x16 = enc.stem(x12)
        for blk in enc.blocks[:k]:
            x16 = blk(x16)

    def atrous():
        z = x16
        for blk in enc.blocks[k:]:
            z = blk(z)
        return z

    c["dlv3_calls"] = {
        "atrous": atrous,
        "head": lambda: seg.decoder(taps, align_corners=seg.align_corners)}
    return c["dlv3_calls"]


def roofline_pct(run, part: str):
    """100 x ``part``'s least time over its device time, or None."""
    if not run.cuda():
        return None
    fns = calls(run)
    if fns is None:
        return None
    with torch.inference_mode():
        seconds = device_seconds(run, fns[part])
    n, h, w, _ = run.frames[0].shape
    work = served_layers(run.cfg, n, h, w)[part]
    return 100.0 * least_seconds(work["flop"], work["bytes"]) / seconds


def mfu(run):
    """100 x the window's FLOPs over its seconds at the bf16 peak."""
    t = run.traffic
    flop = served_flop(run.cfg, int(t["height"]), int(t["width"]))
    return 100.0 * flop * run.window_frames / (run.window_s
                                               * BF16_FLOP_PER_S)
