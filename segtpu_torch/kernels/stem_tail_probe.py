"""The s2d stem (``conv_chw`` k = 2) and the upsample+argmax tails on the
card: each launch shape of the arch0 b8 1024x2048 path (and the sharded
stem's window of a quarter frame plus its halo row), the H-sharded tail
on the four shard windows of the same logits (``space`` at n = 4), and
the W-first tail on G2's b8 512x512 logits beside the H-first tail at
that shape, from seeded inputs, against its plain twin (bit for bit) and
timed in turns with the same function as a PyTorch library call
(``F.conv2d``; ``F.interpolate`` in f32 and ``argmax``), back to back
through the wrapper (``ms``) and as the launches of a CUDA graph of 20
calls (``graph_ms``: the card's time without the Python that issues
them); then the kernels' other forms at odd sizes, bf16 and f32, bit for
bit.

    python3 segtpu_torch/kernels/stem_tail_probe.py [--root DIR]
        [--tiles] [--predict] [--profile] [--out FILE]

``--root`` imports ``segtpu_torch`` from another checkout (a parent
commit unpacked beside this one), so two versions of the kernels are
timed by one script in one call: run it for each, in turns. The shapes
and inputs do not depend on the version. ``--tiles`` times every thread
tile ``conv_k2_kernel`` instantiates (``chw_ops.STEM_TILES``) and every
band of ``upsample_argmax_kernel`` (``upsample_argmax.TAIL_TILES``) at
the path's shapes, and every band of the W-first kernel
(``upsample_argmax.FLAT_TILES``) at G2's, with all 19 classes a chunk
and with 7 and 5, through the C entries, each
checked bit for bit (this checkout's plans only). ``--predict`` also
times ``Segmenter.predict_batch`` on 8 seeded 1024x2048 frames (arch0,
19 classes, random weights from seed 0; CUDA events over 10 calls after
a warm-up), the same frames' ``space`` call on N_SHARDS logical shards
of the card (``ShardedSegmenter``, the sharded tail's path) and
``predict_batch`` of genotype G2 on 8 frames of 512x512 (the W-first
tail's path). ``--profile`` adds the device time of each kernel by name
(torch.profiler) over one pass of the path's calls. Prints the build's
register and spill report, then one JSON line (the card's name and power
limit in it), and writes it to ``--out`` (default
chiprun_out/stem_tail_probe.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM data sheet, f32 outside the tensor cores
F32_FMA_FLOP_PER_S = 59.5e12   # fmaf chains measured on an H100 (exp_vpu_floor)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "stem_tail_probe.json"))
    return ap.parse_args(argv)


# (x shape, Cout) of the stem's launches: the main path and a sharded
# stem's window (a quarter of the frame's 512 rows plus one halo row)
STEM_CALLS = [((8, 12, 512, 1024), 32), ((8, 12, 129, 1024), 32)]
# (logits shape, grid, crop) of the tail's launch on the main path; the
# H-sharded tail runs on its N_SHARDS windows
TAIL_CALLS = [((8, 19, 256, 512), (1024, 2048), None)]
N_SHARDS = 4
# (logits shape, grid) of the W-first tail on G2's b8 512x512 path
FLAT_CALLS = [((8, 19, 128, 128), (512, 512))]
# chip_smoke.py's G2: the genotype whose decoder width (128) takes the
# W-first tail
G2 = [[2, [0, 1, 5, 3], [2, 1, 4, 0], [3, 2, 8, 9]], [[3, 2], [2, 4], [1, 0]]]


def stem_work(shape, cout, esize):
    """(bytes, multiply-adds) of a stem call: x, the weights and bias
    read once, the output written once; 4 * C multiply-adds an output."""
    b, c, h, w = shape
    return (b * c * h * w * esize + cout * c * 4 * esize + cout * 4
            + b * cout * h * w * esize, b * cout * h * w * 4 * c)


def tail_work(shape, grid, esize):
    """(bytes, f32 operations) of a tail call: the logits read and the
    mask written once; the H pass shared by the output columns (2 mul +
    1 add per (class, output row, input column)), the W pass 2 mul + 1
    add and the argmax 1 compare per (class, output pixel)."""
    b, k, h, w = shape
    return (b * k * h * w * esize + b * grid[0] * grid[1],
            b * k * grid[0] * (3 * w + 4 * grid[1]))


def flat_work(shape, grid, esize):
    """(bytes, f32 operations) of a W-first tail call: as ``tail_work``,
    with the W pass shared by the output rows (2 mul + 1 add per (class,
    input row, output column))."""
    b, k, h, w = shape
    return (b * k * h * w * esize + b * grid[0] * grid[1],
            b * k * grid[1] * (3 * h + 4 * grid[0]))


def _bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3


def path_calls(torch, rnd):
    """[(name, kernel fn(use_kernels), library fn, bound ms, f32 FMA floor
    ms or None)] of the path's stem and tail launches."""
    import torch.nn.functional as F
    from segtpu_torch.kernels.chw_ops import conv_chw
    from segtpu_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_flat, upsample_argmax_sharded)
    from segtpu_torch.parallel import halo_exchange
    bf = torch.bfloat16
    calls = []
    for shape, cout in STEM_CALLS:
        x = rnd(*shape).to(bf)
        wt = rnd(cout, shape[1], 2, 2, scale=0.2).to(bf)
        bias = rnd(cout, scale=0.1)

        def k(uk, x=x, wt=wt, bias=bias):
            return conv_chw(x, wt, bias, k=2, act="relu6", use_kernels=uk)

        def lib(x=x, wt=wt, bias=bias):
            h, w = x.shape[-2:]
            return F.conv2d(x, wt, bias.to(bf), padding=1)[..., :h, :w]
        nbytes, fma = stem_work(shape, cout, 2)
        calls.append((f"stem conv_chw k=2 {shape[1]}->{cout} relu6 "
                      f"{tuple(shape)}", k, lib, nbytes / HBM_BYTES_PER_S * 1e3,
                      2 * fma / F32_FMA_FLOP_PER_S * 1e3))
    for shape, grid, crop in TAIL_CALLS:
        x = rnd(*shape).to(bf)

        def k(uk, x=x, grid=grid, crop=crop):
            return upsample_argmax(x, grid, crop_hw=crop, use_kernels=uk)

        def lib(x=x, grid=grid):
            return F.interpolate(x.float(), size=grid, mode="bilinear",
                                 align_corners=True).argmax(1)
        calls.append((f"tail upsample_argmax {tuple(shape)} -> {grid}", k,
                      lib, _bound_ms(*tail_work(shape, grid, 2)), None))
        rows = grid[0] // N_SHARDS
        for s, e in enumerate(halo_exchange(list(x.chunk(N_SHARDS, dim=2)),
                                            1, 1)):
            e = e.contiguous()

            def k(uk, e=e, s=s, grid=grid):
                return upsample_argmax_sharded(e, grid, shard=s,
                                               n_shards=N_SHARDS,
                                               use_kernels=uk)

            def lib(e=e, rows=rows, grid=grid):
                return F.interpolate(e.float(), size=(rows, grid[1]),
                                     mode="bilinear",
                                     align_corners=True).argmax(1)
            calls.append((f"sharded tail shard {s}/{N_SHARDS} "
                          f"{tuple(e.shape)} -> {rows}x{grid[1]}", k, lib,
                          _bound_ms(*tail_work(tuple(e.shape),
                                               (rows, grid[1]), 2)), None))
    for shape, grid in FLAT_CALLS:
        x = rnd(*shape).to(bf)
        b, c, h, w = shape
        flat = x.reshape(b, c, h * w)

        def k(uk, flat=flat, hw=(h, w), grid=grid):
            return upsample_argmax_flat(flat, hw, grid, use_kernels=uk)

        def lib(x=x, grid=grid):
            return F.interpolate(x.float(), size=grid, mode="bilinear",
                                 align_corners=True).argmax(1)

        def h_first(uk, x=x, grid=grid):
            return upsample_argmax(x, grid, use_kernels=uk)
        calls.append((f"flat tail upsample_argmax_flat {tuple(shape)} -> "
                      f"{grid}", k, lib, _bound_ms(*flat_work(shape, grid, 2)),
                      None))
        calls.append((f"tail upsample_argmax {tuple(shape)} -> {grid} (the "
                      f"H-first kernel at G2's shape)", h_first, lib,
                      _bound_ms(*tail_work(shape, grid, 2)), None))
    return calls


def graph_ms(torch, fn, n: int = 20, reps: int = 10):
    """ms a call of ``fn`` as the launches of a CUDA graph of ``n`` calls,
    replayed ``reps`` times between CUDA events: the card's time without
    the Python that issues the launches; None where the capture fails."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(n):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * n)
    except RuntimeError as e:       # a refused capture: "not measured"
        print(f"[graph] not measured: {type(e).__name__}: {e}")
        return None


def forms(torch, rnd):
    """[(name, fn(use_kernels))]: the stem's and the tail's other forms at
    odd sizes, bf16 and f32: ragged widths (scalar paths), a plane off a
    16-byte boundary, other channel counts (Cout over two blocks), acc
    and vec_acc, a window of rows; the tail cropped to a ragged width, at
    align_corners False, at an odd scale, and with 150 classes in f32
    (staged in chunks of classes)."""
    from segtpu_torch.kernels.chw_ops import conv_chw
    from segtpu_torch.kernels.upsample_argmax import upsample_argmax
    out = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for (b, cin, h, w), cout, act, acc, vec in [
                ((2, 12, 37, 70), 32, "relu6", False, False),
                ((2, 12, 9, 1000), 32, "relu6", True, False),
                ((2, 7, 12, 24), 19, "relu", False, True),
                ((1, 48, 5, 130), 100, "none", True, True),
                ((2, 24, 16, 64), 8, "relu", False, False)]:
            x = rnd(b, cin, h, w).to(dt)
            wt = rnd(cout, cin, 2, 2, scale=0.2).to(dt)
            bias = rnd(cout, scale=0.1)
            a = rnd(b, cout, h, w).to(dt) if acc else None
            v = rnd(b, cout) if vec else None
            out.append((f"stem k=2 {cin}->{cout} {act} {h}x{w} acc={acc} "
                        f"vec={vec} {tag}",
                        lambda uk, x=x, wt=wt, bias=bias, a=a, v=v, act=act:
                        conv_chw(x, wt, bias, a, v, k=2, act=act,
                                 use_kernels=uk)))
        # a plane 2 elements off a 16-byte boundary, and a window of rows
        # of a larger map (the sharded stem's halo window)
        flat = rnd(2 * 12 * 16 * 64 + 2).to(dt)
        off = flat[2:].view(2, 12, 16, 64)
        big = rnd(2, 12, 40, 64).to(dt)
        win = big[:, :, 19:30].contiguous()
        wt = rnd(32, 12, 2, 2, scale=0.2).to(dt)
        bias = rnd(32, scale=0.1)
        for what, x in (("unaligned plane 16x64", off),
                        ("window rows 19..29 of 40x64", win)):
            out.append((f"stem k=2 12->32 {what} {tag}",
                        lambda uk, x=x, wt=wt, bias=bias: conv_chw(
                            x, wt, bias, k=2, act="relu6", use_kernels=uk)))
        for shape, grid, crop, ac in [
                ((1, 19, 256, 376), (1024, 1504), (1000, 1500), True),
                ((2, 19, 64, 128), (256, 512), None, False),
                ((2, 5, 9, 13), (40, 50), None, True),
                ((1, 7, 24, 36), (96, 144), (90, 141), False)]:
            x = rnd(*shape).to(dt)
            out.append((f"tail {tuple(shape)} -> {grid} crop={crop} "
                        f"align_corners={ac} {tag}",
                        lambda uk, x=x, grid=grid, crop=crop, ac=ac:
                        upsample_argmax(x, grid, crop_hw=crop,
                                        align_corners=ac, use_kernels=uk)))
    x = rnd(1, 150, 32, 64)
    out.append(("tail (1, 150, 32, 64) -> (128, 256) f32, class chunks",
                lambda uk, x=x: upsample_argmax(x, (128, 256),
                                                use_kernels=uk)))
    return out


def tile_sweep(torch, rnd, cuda_ms):
    """[{kernel, tile, ms, bits_equal}] of every stem tile at the main
    path's stem and every tail band at its tail, each launched through the
    C entry with the plan for the tile."""
    import ctypes
    import importlib
    from segtpu_torch.kernels import chw_ops
    ua = importlib.import_module("segtpu_torch.kernels.upsample_argmax")
    rows = []
    (shape, cout), = STEM_CALLS[:1]
    b, c, h, w = shape
    x = rnd(*shape).to(torch.bfloat16)
    wt = rnd(cout, c, 2, 2, scale=0.2).to(torch.bfloat16)
    bias = rnd(cout, scale=0.1)
    want = chw_ops.conv_chw(x, wt, bias, k=2, act="relu6", use_kernels=False)
    out = torch.empty_like(want)
    fn = chw_ops._conv_entry()
    for tile in chw_ops.STEM_TILES:
        args = chw_ops.stem_args(c, cout, w, 2,
                                 [x.data_ptr(), out.data_ptr()], tile)
        plan = (ctypes.c_int * 8)(*args)

        def run(plan=plan, tile=tile):
            rc = fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), None, None,
                    out.data_ptr(), b, c, cout, h, w, 2, 1, 0,
                    chw_ops._ACT_CODE["relu6"], 1, ctypes.addressof(plan),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"stem tile {tile}: CUDA error {rc}")
        run()
        rows.append(dict(kernel="conv_k2_kernel", shape=list(shape),
                         tile=list(tile), plan=list(args), ms=cuda_ms(run),
                         bits_equal=_bits(torch, out, want)[0]))
        print(f"[tiles] {rows[-1]}")
    (shape, grid, crop), = TAIL_CALLS
    b, k, h, w = shape
    logits = rnd(*shape).to(torch.bfloat16)
    want = ua.upsample_argmax(logits, grid, use_kernels=False)
    out = torch.empty_like(want)
    tables = ua._device_tables(h, w, *grid, *grid, True, True,
                               logits.device)
    fn = ua._tail_entry()
    for tile in ua.TAIL_TILES:
        p = ua.tail_plan(h, w, *grid, *grid, True, k, 2, tile)
        plan = (ctypes.c_int * 8)(*ua.tail_args(p, w, grid[1], 2,
                                                logits.data_ptr(),
                                                out.data_ptr()))

        def run(plan=plan, tile=tile):
            rc = fn(logits.data_ptr(), out.data_ptr(), b, k, h, w, *grid, 1,
                    *(t.data_ptr() for t in tables), ctypes.addressof(plan),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"tail tile {tile}: CUDA error {rc}")
        run()
        rows.append(dict(kernel="upsample_argmax_kernel", shape=list(shape),
                         tile=list(tile), plan=list(p), ms=cuda_ms(run),
                         bits_equal=bool(torch.equal(out, want))))
        print(f"[tiles] {rows[-1]}")
    (shape, grid), = FLAT_CALLS
    b, k, h, w = shape
    logits = rnd(*shape).to(torch.bfloat16)
    flat = logits.reshape(b, k, h * w)
    want = ua.upsample_argmax_flat(flat, (h, w), grid, use_kernels=False)
    out = torch.empty_like(want)
    tables = ua._flat_device_tables(h, w, *grid, *grid, True, True,
                                    logits.device)
    fn = ua._flat_entry()
    for tile, kc in [(t, c) for t in ua.FLAT_TILES for c in (k, 7, 5)]:
        p = ua.flat_plan(h, w, *grid, *grid, True, k, 2, tile)
        p = p._replace(kc=kc, smem=ua.flat_smem(p.nr, p.nc, kc, 2))
        plan = (ctypes.c_int * 8)(*ua.tail_args(p, w, grid[1], 2,
                                                logits.data_ptr(),
                                                out.data_ptr(), ua.FLAT_PX))

        def run(plan=plan, tile=tile):
            rc = fn(logits.data_ptr(), out.data_ptr(), b, k, h, w, *grid, 1,
                    *(t.data_ptr() for t in tables), ctypes.addressof(plan),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"flat tail tile {tile}: CUDA error {rc}")
        run()
        rows.append(dict(kernel="upsample_argmax_flat_kernel",
                         shape=list(shape), tile=list(tile), plan=list(p),
                         ms=cuda_ms(run),
                         bits_equal=bool(torch.equal(out, want))))
        print(f"[tiles] {rows[-1]}")
    return rows


def _bits(torch, got, want):
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    err = (got.float() - want.float()).abs().max().item()
    return bool(torch.equal(got.view(view), want.view(view))), err


def tail_paths_ms(torch, cuda_ms) -> dict:
    """ms of the two tails' serving paths: the space call of arch0 on
    N_SHARDS logical shards of the card (the sharded tail's) on 8 seeded
    1024x2048 frames, and G2's predict_batch on 8 frames of 512x512 (the
    W-first tail's); random weights from seed 0."""
    import numpy as np
    from segtpu_torch.engine import Segmenter, ShardedSegmenter
    from segtpu_torch.models import ARCHS, create_segmenter
    frames = np.random.default_rng(3).integers(0, 256, (8, 1024, 2048, 3),
                                               dtype=np.uint8)
    out = {}
    for key, genotype, fr in (("space_ms", ARCHS["arch0"], frames),
                              ("g2_predict_batch_ms", G2,
                               frames[:, :512, :512].copy())):
        model = create_segmenter(genotype, 19,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
        seg = Segmenter(model, device="cuda")
        x = torch.from_numpy(fr).cuda()
        if key == "space_ms":
            sharded = ShardedSegmenter(seg,
                                       [torch.device("cuda", 0)] * N_SHARDS)
            out[key] = cuda_ms(lambda: sharded.predict(x), 10)
        else:
            out[key] = cuda_ms(lambda: seg.predict_batch(x), 10)
    return out


def build_report(build) -> list:
    """The ptxas register and spill lines of the two libraries."""
    lines = []
    for name, lib in build(["conv_chw", "upsample_argmax"]).items():
        log = f"{lib}.log"
        if os.path.exists(log):
            lines += [f"{name}: {ln.strip()}" for ln in open(log)
                      if "registers" in ln or "spill" in ln]
    return lines


def main(argv=None):
    args = _args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("stem_tail_probe needs a CUDA card")
    import segtpu_torch
    from segtpu_torch.kernels import _build
    from segtpu_torch.kernels.pw_resize_probe import (gpu_line, predict_ms,
                                                      seeded)
    from segtpu_torch.scripts import cuda_ms, turns_ms
    t0 = time.perf_counter()
    report = build_report(_build.build)
    res = {"root": os.path.dirname(os.path.abspath(segtpu_torch.__file__)),
           "gpu": gpu_line(), "build_s": time.perf_counter() - t0,
           "ptxas": report, "calls": [], "forms": []}
    for line in report:
        print(f"[build] {line}")
    ok = True
    rnd = seeded(torch, 11)
    with torch.inference_mode():
        calls = path_calls(torch, rnd)
        for name, fn, lib, bound, fma_floor in calls:
            same, err = _bits(torch, fn(True), fn(False))
            ok &= same
            t = turns_ms({"ms": lambda: fn(True), "library_ms": lib}, cuda_ms)
            row = dict(name=name, bits_equal=same, max_abs_err=err, **t,
                       graph_ms=graph_ms(torch, lambda: fn(True)),
                       bound_ms=bound, fma_floor_ms=fma_floor)
            res["calls"].append(row)
            print(json.dumps(row))
        for name, fn in forms(torch, rnd):
            same, err = _bits(torch, fn(True), fn(False))
            ok &= same
            res["forms"].append(dict(name=name, bits_equal=same,
                                     max_abs_err=err))
            print(f"[form] {name}: bit-identical={same} max_abs_err={err!r}")
        if args.predict:
            res["predict_batch_ms"] = predict_ms(torch, cuda_ms)
            print(f"[predict] b8 1024x2048: {res['predict_batch_ms']:.4f} ms")
            res.update(tail_paths_ms(torch, cuda_ms))
            print(f"[predict] space n={N_SHARDS} b8 1024x2048: "
                  f"{res['space_ms']:.4f} ms; G2 b8 512x512: "
                  f"{res['g2_predict_batch_ms']:.4f} ms")
        if args.tiles:
            res["tiles"] = tiles = tile_sweep(torch, rnd, cuda_ms)
            ok &= all(r["bits_equal"] for r in tiles)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            for _, fn, *_ in calls:
                fn(True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                for _, fn, *_ in calls:
                    fn(True)
                torch.cuda.synchronize()
            res["profile"] = {
                e.key: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0)) / 1e3
                for e in p.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
            print(p.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=8))
    res["ok"] = bool(ok)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("root", "gpu", "ok")}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
