"""Closed-loop serving of device-resident batches: ``predict_batch`` on a
ring of ``ring`` distinct uint8 batches [batch, height, width, 3] made on
the card from the seed, called back to back with at most ``depth`` calls
in flight (the host runs ahead of the card, as a caller decoding video on
the card would).

End to end: ``images_per_s``, every mask completed in the window over the
window's time, which ends in a synchronize.

Check: each call's masks must equal, pixel for pixel, those of the same
batch's call in set-up (the ring's first pass, through the same program);
the calls that differ count as failed. The set-up masks of ``check_slots``
batches drawn from the seed are compared with the reference
(``served.mask_checks``).
"""

from __future__ import annotations

import time

import torch

from benchmark import served
from benchmark.trace import record_function
from benchmark.weights import make_frames


def setup(run):
    t = run.traffic
    served.setup_engine(run)
    t0 = time.perf_counter()
    n, h, w = int(t["batch"]), int(t["height"]), int(t["width"])
    run.frames = [make_frames(run.seed, 1 + s, n, h, w, run.device)
                  for s in range(int(t["ring"]))]
    t1 = time.perf_counter()
    # the first call captures the shape's program; a pass over the ring
    # gives each batch's masks, which every later call must repeat
    run.keep = [run.seg.predict_batch(f) for f in run.frames]
    run.sync()
    t2 = time.perf_counter()
    for f in run.frames:
        run.seg.predict_batch(f)
    run.sync()
    run.bad = torch.zeros((), dtype=torch.int64, device=run.device)
    run.note(frames_s=t1 - t0, capture_and_first_pass_s=t2 - t1,
             warm_pass_s=time.perf_counter() - t2)


def _calls(run, seconds: float, label: str) -> tuple:
    seg, frames, keep = run.seg, run.frames, run.keep
    fence = served.Fence(run.device, int(run.traffic["depth"]))
    ring = len(frames)
    run.sync()
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t0 < seconds:
        s = calls % ring
        with record_function(label):
            out = seg.predict_batch(frames[s])
            run.bad += (out != keep[s]).any()
        fence.mark()
        calls += 1
    run.sync()
    return calls, time.perf_counter() - t0


def window(run, seconds: float) -> dict:
    calls, elapsed = _calls(run, seconds, "bench.call")
    frames = calls * int(run.traffic["batch"])
    run.attempted += frames
    run.window_frames, run.window_s = frames, elapsed
    run.window_requests = calls
    run.note(window_calls=calls, window_s=elapsed)
    return {"images_per_s": frames / elapsed}


def traced(run, seconds: float) -> int:
    return _calls(run, seconds, "bench.call")[0]


def release(run):
    bad = int(run.bad)
    run.failed += bad * int(run.traffic["batch"])
    run.inconsistent_calls = bad
    del run.seg
    if run.cuda():
        torch.cuda.empty_cache()


def check(run) -> dict:
    slots = served.sample(run.seed, len(run.frames),
                          int(run.traffic["check_slots"]))
    frames = torch.cat([run.frames[s] for s in slots])
    masks = torch.cat([run.keep[s] for s in slots])
    del run.frames
    out = {"inconsistent_calls": (float(run.inconsistent_calls), 0.0)}
    out.update(served.mask_checks(run, frames, masks))
    return out
