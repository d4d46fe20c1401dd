"""Throughput benchmark of the served inference call on one card
(counterpart: ``bench.py`` at the repository root, the JAX package's).

    python -m segtpu_torch.bench                 # arch0, b8, 1024x2048
    python -m segtpu_torch.bench --arch arch1    # or BENCH_ARCH=arch1
    python -m segtpu_torch.main_search bench --arch arch2
    python -m segtpu_torch.bench --device cpu    # format only, host clock

Prints ONE JSON line on stdout:

    {"metric": "cityscapes_{h}x{w}_{arch}_inference_throughput_per_gpu",
     "value": images/s, "unit": "images/sec", "compile_s", "build_s",
     "capture_s", "first_exec_s", "aot_hit", "compile_cache",
     "flops_per_frame_g_analytic", "roofline_ips", "pct_of_roofline",
     "attainable_ips", "pct_of_attainable", "gpu"}

and a ``#`` line on stderr with the settings, the eager call's images/s
beside the graph's (the ``SEGTPU_NO_AOT=1`` path, in the same process)
and ``predict_stream``'s from host frames (host to card to host).

Method: random weights from a seeded generator (19 classes); BENCH_SCAN
distinct batches of uint8 frames made on the card; ``predict_batch`` on
those device tensors, through the engine's program cache (a CUDA graph
per shape, ``utils.aot``); CUDA events around BENCH_REPS passes over the
batches after one warm-up pass, and a checksum of every batch's masks,
kept on the card and read back at the end, as the hard sync.
``compile_s`` is ``build_s`` (``nvcc``, 0 when every library was built
already), ``capture_s`` (the warm-up call and the graph's capture) and
``first_exec_s`` (the first replay, read back). ``aot_hit``: this process
compiled none of the program's libraries (a warm start). The ceilings
come from ``utils.roofline`` at the H100's rates. ``--device cpu`` runs
the plain versions eagerly and times on the host's clock: it checks the
output's form, and its numbers are no measurement of a card.

Env overrides: BENCH_HW=HxW, BENCH_BATCH=n, BENCH_REPS=n,
BENCH_ARCH=arch0|arch1|arch2 (``--arch`` wins), BENCH_SCAN=n.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

NUM_CLASSES = 19     # CityScapes
SEED = 0


def gpu_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class _Clock:
    """CUDA events on a card, the host's clock on the CPU; ms."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def _passes(seg, frames, reps: int, chk):
    for _ in range(reps):
        for f in frames:
            chk += seg.predict_batch(f).sum(dtype=torch.int64)
    return chk


def run(device="cuda", arch=None) -> dict:
    """The benchmark of ``arch`` (default BENCH_ARCH, else arch0) on
    ``device``; returns the JSON record."""
    from segtpu_torch.engine import Segmenter
    from segtpu_torch.models import ARCHS, create_segmenter
    from segtpu_torch.utils.cache import enable_compilation_cache
    from segtpu_torch.utils.helpers import resolve_device
    from segtpu_torch.utils.roofline import compute_roofline

    cache_dir = enable_compilation_cache()
    dev = resolve_device(device)
    h, w = (int(v) for v in os.environ.get("BENCH_HW", "1024x2048").split("x"))
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    reps = int(os.environ.get("BENCH_REPS", "4"))
    scan = int(os.environ.get("BENCH_SCAN", "64"))
    arch = arch or os.environ.get("BENCH_ARCH", "arch0")
    if arch not in ARCHS:
        raise ValueError(f"BENCH_ARCH is one of {sorted(ARCHS)}, not {arch}")
    model = create_segmenter(ARCHS[arch], NUM_CLASSES, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    seg = Segmenter(model, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = [torch.randint(0, 256, (batch, h, w, 3), generator=gen,
                            dtype=torch.uint8, device=dev)
              for _ in range(scan)]

    prog = seg._compiled((h, w), False, tuple(frames[0].shape))
    t0 = time.perf_counter()
    first = int(seg.predict_batch(frames[0]).sum())
    first_exec_s = time.perf_counter() - t0
    compile_s = prog.build_s + prog.capture_s + first_exec_s

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    _passes(seg, frames, 1, zero.clone())                  # warm-up pass
    with _Clock(dev) as clock:
        chk = _passes(seg, frames, reps, zero.clone())
    checksum = int(chk)                                    # the hard sync
    ips = batch * scan * reps / clock.ms * 1e3

    # the eager call (the SEGTPU_NO_AOT=1 path) on the same weights
    saved = os.environ.get("SEGTPU_NO_AOT")
    os.environ["SEGTPU_NO_AOT"] = "1"
    try:
        eager = Segmenter(model, device=dev)
        _passes(eager, frames[:1], 1, zero.clone())
        with _Clock(dev) as eclock:
            echk = _passes(eager, frames, 1, zero.clone())
        int(echk)
    finally:
        if saved is None:
            del os.environ["SEGTPU_NO_AOT"]
        else:
            os.environ["SEGTPU_NO_AOT"] = saved
    eager_ips = batch * scan / eclock.ms * 1e3

    # host frames through predict_stream: host to card to host
    host = [f.cpu().numpy() for f in frames[0][:min(batch, 4)]]
    stream_in = [host[i % len(host)] for i in range(2 * batch)]
    list(seg.predict_stream(stream_in[:1]))               # that shape's graph
    t0 = time.perf_counter()
    n_out = sum(1 for _ in seg.predict_stream(stream_in))
    e2e_ips = n_out / (time.perf_counter() - t0)

    roof = compute_roofline(h, w, arch, num_classes=NUM_CLASSES)
    gpu = gpu_line(dev)
    print(f"# compile={compile_s:.3f}s (build={prog.build_s:.3f} "
          f"capture={prog.capture_s:.3f} exec1={first_exec_s:.3f}) "
          f"cache_dir={cache_dir} batch={batch} scan={scan} reps={reps} "
          f"shape={h}x{w} arch={arch} device={dev} gpu={gpu} "
          f"graph_ips={ips!r} eager_ips={eager_ips!r} "
          f"e2e_predict_stream_ips={e2e_ips!r} checksum={checksum} "
          f"first_checksum={first}", file=sys.stderr)
    return {
        "metric": f"cityscapes_{h}x{w}_{arch}_inference_throughput_per_gpu",
        "value": round(ips, 2),
        "unit": "images/sec",
        "compile_s": round(compile_s, 3),
        "build_s": round(prog.build_s, 3),
        "capture_s": round(prog.capture_s, 3),
        "first_exec_s": round(first_exec_s, 3),
        "aot_hit": bool(prog.aot_hit),
        "compile_cache": bool(cache_dir),
        "flops_per_frame_g_analytic": round(roof["gflop_total"], 2),
        "roofline_ips": round(roof["roofline_ips"], 1),
        "pct_of_roofline": round(100 * ips / roof["roofline_ips"], 1),
        "attainable_ips": round(roof["attainable_ips"], 1),
        "pct_of_attainable": round(100 * ips / roof["attainable_ips"], 1),
        "gpu": gpu,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("segtpu_torch.bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default=None,
                    help="arch0, arch1 or arch2 (default BENCH_ARCH, arch0)")
    args = ap.parse_args(argv)
    record = run(args.device, args.arch)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
