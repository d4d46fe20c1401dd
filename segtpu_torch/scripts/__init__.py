"""The TPU experiments under ``scripts/`` that held Pallas kernels, ported
one module each (``exp_vpu_floor``, ``exp_front_kernel``,
``ab_normalize``, ``exp_tail_flat``). Each runs its A/B on the card:

    python3 -m segtpu_torch.scripts.exp_tail_flat

and raises when no card is present, unless ``run(device="cpu")`` is
asked for; on the CPU the kernels' plain twins run and nothing is timed.
The engine does not call them.
"""

from __future__ import annotations

import argparse
import select
import subprocess

import torch

from segtpu_torch.utils.helpers import resolve_device


def cuda_ms(fn, iters=None, warmup: int = 3, window_ms: float = 25.0) -> float:
    """Milliseconds per call of ``fn`` on the card, by CUDA events around
    ``iters`` calls after ``warmup`` calls. ``iters=None`` sizes the run
    from one timed call to a window of about ``window_ms`` (at least 3
    calls, at most 2000), long enough for the card's clocks to settle."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if iters is None:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        iters = int(min(max(window_ms / max(start.elapsed_time(end), 1e-3), 3),
                        2000))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def with_clock_samples(fn, period_ms: int = 50):
    """Run ``fn()`` while ``nvidia-smi`` samples the card's SM clock (MHz)
    and power draw (W) every ``period_ms``, from its first sample on.
    Returns (fn's result, [(MHz, W), ...]); the list is empty where
    nvidia-smi gives no samples."""
    cmd = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
           "--format=csv,noheader,nounits", "-lms", str(period_ms), "-i", "0"]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return fn(), []
    try:
        # the sampler is live once it has printed; that sample is dropped
        if select.select([proc.stdout], [], [], 10.0)[0]:
            proc.stdout.readline()
        out = fn()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    samples = []
    for line in text.splitlines():
        try:
            mhz, watts = (float(v) for v in line.split(","))
        except ValueError:
            continue
        samples.append((mhz, watts))
    return out, samples


def timer(dev: torch.device):
    """``ms(fn)``: CUDA-event time on a card; None on the CPU, where no
    device time exists."""
    if dev.type != "cuda":
        return lambda fn: None
    return cuda_ms


def turns_ms(arms: dict, ms_of) -> dict:
    """{name: ms} of A/B arms timed in turns, A B ... then ... B A, each
    arm's lower time of its two (None on the CPU)."""
    names = list(arms)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(ms_of(arms[n]))
    return {n: None if None in t else min(t) for n, t in times.items()}


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def fmt_ms(ms) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:.4f} ms"


def bits_equal(a, b) -> bool:
    """Same shape and the same bits (float tensors compared as integers)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def device_arg(description: str, argv=None, **extra):
    """Parse ``--device`` (default cuda) and ``extra`` positional args."""
    ap = argparse.ArgumentParser(description=description)
    for name, kw in extra.items():
        ap.add_argument(name, **kw)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args
