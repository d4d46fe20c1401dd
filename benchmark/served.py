"""What the serving loops share: the engine's set-up, a bounded run-ahead
on the card, and the comparison of served masks with the reference.

The comparison (what decides ``correct`` in a serving cell): for every
pixel of the sampled frames, the reference's f32 logits at full
resolution give the gap by which the served class's logit lies below
the best, in units of the frame's logit spread; the widest gap is the
number compared. Also counted: the share of pixels whose served class is not
the reference's argmax (ties to the lower class). A served mask of the
wrong shape reads infinite.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from benchmark import program
from benchmark.reference.model import exact_f32, served_logits
from benchmark.weights import make_weights


class Fence:
    """Keeps at most ``depth`` calls in flight on the card: after each
    call an event, and a wait on the event ``depth`` calls back. A
    no-op on the CPU, whose calls are synchronous."""

    def __init__(self, device, depth: int):
        self.cuda = torch.device(device).type == "cuda"
        self.depth = int(depth)
        self.events = collections.deque()

    def mark(self):
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > self.depth:
            self.events.popleft().synchronize()


def setup_engine(run):
    """Builds the kernels, makes the weights and the engine; ``run.seg``,
    ``run.weights``."""
    t0 = time.perf_counter()
    built = program.build_kernels(run.device)
    t1 = time.perf_counter()
    program.init_device(run.device)
    t2 = time.perf_counter()
    run.weights = make_weights(run.cfg, run.seed, run.device)
    run.sync()
    t3 = time.perf_counter()
    run.seg = program.build_engine(run.cfg, run.weights, run.device)
    run.sync()
    run.note(build_s=built["build_s"], built=built["built"],
             kernels_s=t1 - t0, device_init_s=t2 - t1, weights_s=t3 - t2,
             engine_s=time.perf_counter() - t3)


def compare_masks(run, frames, masks):
    """(widest gap, mismatch %) of uint8 masks [n, H, W] (tensor or numpy)
    against the reference on uint8 frames [n, H, W, 3] (same), a frame at
    a time on the run's device. A pixel's gap is the reference's best
    logit less its logit of the served class, in units of the frame's
    logit spread (the mean over its pixels of the standard deviation over
    classes), so that it reads alike on weights whose logits are larger."""
    widest, wrong, total = 0.0, 0, 0
    with exact_f32(), torch.no_grad():
        for i in range(len(frames)):
            f = torch.as_tensor(frames[i:i + 1]).to(run.device)
            m = torch.as_tensor(masks[i:i + 1]).to(run.device)
            lg = served_logits(run.weights, run.cfg, f)
            if tuple(m.shape) != (1, *lg.shape[-2:]) or m.dtype != torch.uint8:
                return float("inf"), float("inf")
            bad = m.long() >= lg.shape[1]
            got = lg.gather(1, m.long().clamp_max(lg.shape[1] - 1)[:, None])
            gap = (lg.max(1).values - got[:, 0]) / lg.std(1).mean()
            gap = torch.where(bad, torch.inf, gap)
            widest = max(widest, float(gap.max()))
            wrong += int((lg.argmax(1) != m.long()).sum())
            total += m.numel()
            del lg
    return widest, 100.0 * wrong / max(total, 1)


def mask_checks(run, frames, masks) -> dict:
    """{number: (value, limit)} of the comparison, the limit from the
    cell's limits. The share of pixels on another class is
    noted, not compared: it counts near-ties, which the weights make
    plentiful, and swings from seed to seed."""
    widest, mismatch = compare_masks(run, frames, masks)
    run.note(mismatch_pct=mismatch, compared_frames=len(frames))
    return {"widest_gap": (widest, float(run.limits["widest_gap"]))}


def sample(seed: int, n: int, k: int) -> list:
    """``k`` of ``range(n)`` drawn from the seed, sorted."""
    rng = np.random.default_rng(int(seed))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))
