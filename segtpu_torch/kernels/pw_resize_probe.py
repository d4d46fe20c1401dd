"""The decoder's 1x1 ``conv_chw`` and chained ``resize_chw`` on the card:
each launch shape of the arch0 b8 1024x2048 path, from seeded inputs,
against its plain twin (bit for bit) and timed in turns with the same
function as PyTorch library calls (``F.conv2d``, ``F.interpolate``);
then the kernels' other forms at odd sizes, bf16 and f32, bit for bit.

    python3 segtpu_torch/kernels/pw_resize_probe.py [--root DIR]
        [--profile] [--tiles] [--predict] [--out FILE]

``--root`` imports ``segtpu_torch`` from another checkout (a parent
commit unpacked beside this one), so two versions of the kernels are
timed by one script in one call: run it for each, in turns. The shapes
and inputs do not depend on the version. ``--profile`` adds the device
time of each kernel by name (torch.profiler) over one pass of the six
calls. ``--tiles`` times every thread tile ``conv1x1_kernel``
instantiates (``chw_ops.CONV1X1_TILES``) at the two 1x1 launch shapes,
each checked bit for bit; the plan's tile should be within a few percent
of the fastest. ``--predict`` also times ``Segmenter.predict_batch`` on
8 seeded 1024x2048 frames on the card (arch0, 19 classes, random weights
from seed 0; CUDA events over 10 calls after a warm-up). Prints one JSON
line (the card's name and power limit in
it) and writes it to ``--out`` (default chiprun_out/pw_resize_probe.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "pw_resize_probe.json"))
    return ap.parse_args(argv)


# (x shape, Cout, act) of the three 1x1 calls; (x shape, output size, raw
# channels) of the three chained resizes (adapt to 48, aggregate 48 -> 48)
CONV_CALLS = [((8, 48, 64, 128), 48, "relu"), ((8, 48, 128, 256), 48, "relu"),
              ((8, 48, 256, 512), 19, "none")]
RESIZE_CALLS = [((8, 48, 32, 64), (64, 128), 96),
                ((8, 48, 64, 128), (128, 256), 32),
                ((8, 48, 128, 256), (256, 512), 24)]


def seeded(torch, seed: int):
    """rnd(*shape, scale=1.0): normal values on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    return rnd


def _bits(torch, got, want):
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    view = torch.int16 if got.element_size() == 2 else torch.int32
    err = (got.float() - want.float()).abs().max().item()
    return bool(torch.equal(got.view(view), want.view(view))), err


def path_calls(torch, rnd):
    """[(name, kernel fn(use_kernels), library fn, work (bytes, fma))]."""
    import torch.nn.functional as F
    from segtpu_torch.kernels.chw_ops import conv_chw
    from segtpu_torch.kernels.resize_chw import resize_chw
    bf = torch.bfloat16
    calls = []
    for shape, cout, act in CONV_CALLS:
        b, c, h, w = shape
        x = rnd(*shape).to(bf)
        wt = rnd(cout, c, 1, 1, scale=0.15).to(bf)
        bias = rnd(cout, scale=0.1)
        relu = act == "relu"

        def k(uk, x=x, wt=wt, bias=bias, act=act):
            return conv_chw(x, wt, bias, k=1, act=act, use_kernels=uk)

        def lib(x=x, wt=wt, bias=bias, relu=relu):
            y = F.conv2d(x, wt, bias.to(bf))
            return F.relu(y) if relu else y
        px = b * h * w
        calls.append((f"conv_chw 1x1 {c}->{cout} {act} {tuple(shape)}", k,
                      lib, (px * (c + cout) * 2 + cout * c * 2 + cout * 4,
                            px * c * cout)))
    for shape, hw, rc in RESIZE_CALLS:
        b, c, h, w = shape
        x = rnd(*shape).to(bf)
        raw = rnd(b, rc, *hw).to(bf)
        stages = [(rnd(c, rc, 1, 1, scale=0.15).to(bf), rnd(c, scale=0.1)),
                  (rnd(c, c, 1, 1, scale=0.15).to(bf), rnd(c, scale=0.1))]

        def k(uk, x=x, hw=hw, raw=raw, stages=stages):
            return resize_chw(x, hw, acc_chain=(raw, stages), use_kernels=uk)

        def lib(x=x, hw=hw, raw=raw, stages=stages):
            y = raw
            for wt, bias in stages:
                y = F.relu(F.conv2d(y, wt, bias.to(bf)))
            return F.interpolate(x, size=hw, mode="bilinear",
                                 align_corners=True) + y
        px = b * hw[0] * hw[1]
        calls.append((f"resize_chw {tuple(shape)} -> {hw} chain {rc}->{c}->"
                      f"{c}", k, lib,
                      (x.numel() * 2 + raw.numel() * 2 + px * c * 2,
                       px * (rc * c + c * c))))
    return calls


def _resize_forms(rnd, dt):
    """{name: fn(use_kernels)}: resize_chw's forms at odd sizes in dt."""
    from segtpu_torch.kernels.resize_chw import resize_chw
    chain3 = [(rnd(24, 16, 1, 1, scale=0.2).to(dt), rnd(24, scale=0.1)),
              (rnd(20, 24, 1, 1, scale=0.2).to(dt), rnd(20, scale=0.1)),
              (rnd(16, 20, 1, 1, scale=0.2).to(dt), rnd(16, scale=0.1))]
    one = [(rnd(16, 16, 1, 1, scale=0.2).to(dt), rnd(16, scale=0.1))]
    wide = [(rnd(100, 16, 1, 1, scale=0.2).to(dt), rnd(100, scale=0.1)),
            (rnd(16, 100, 1, 1, scale=0.2).to(dt), rnd(16, scale=0.1))]
    small, raw = rnd(2, 16, 19, 35).to(dt), rnd(2, 16, 37, 70).to(dt)
    big, acc = rnd(2, 96, 16, 32).to(dt), rnd(2, 96, 32, 64).to(dt)
    many = rnd(1, 700, 8, 128).to(dt)
    cases = {
        "3 stages 19x35->37x70 half-pixel": lambda uk: resize_chw(
            small, (37, 70), acc_chain=(raw, chain3),
            align_corners=False, use_kernels=uk),
        "1 stage 19x35->37x70": lambda uk: resize_chw(
            small, (37, 70), acc_chain=(raw, one), use_kernels=uk),
        "stage 0 100 wide 19x35->37x70": lambda uk: resize_chw(
            small, (37, 70), acc_chain=(raw, wide), use_kernels=uk),
        "acc 96 channels 16x32->32x64": lambda uk: resize_chw(
            big, (32, 64), acc, use_kernels=uk),
        "plain 96 channels 16x32->40x600": lambda uk: resize_chw(
            big, (40, 600), use_kernels=uk),
        "plain 700 channels 8x128->16x1024": lambda uk: resize_chw(
            many, (16, 1024), use_kernels=uk),
    }
    return cases


def forms(torch, rnd):
    """[(name, fn(use_kernels))]: the kernels' other forms, odd sizes,
    bf16 and f32."""
    from segtpu_torch.kernels.chw_ops import conv_chw
    from segtpu_torch.kernels.resize_chw import resize_chw, shard_interp_bands
    from segtpu_torch.parallel import halo_exchange
    out = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for (b, cin, h, w), cout, act, acc, vec in [
                ((2, 48, 37, 70), 19, "none", True, True),
                ((2, 48, 12, 20), 48, "relu", True, False),
                ((2, 96, 64, 128), 19, "none", False, False),
                ((2, 24, 9, 13), 96, "relu6", False, True),
                ((1, 320, 16, 32), 160, "relu", True, True)]:
            x = rnd(b, cin, h, w).to(dt)
            wt = rnd(cout, cin, 1, 1, scale=0.15).to(dt)
            bias = rnd(cout, scale=0.1)
            a = rnd(b, cout, h, w).to(dt) if acc else None
            v = rnd(b, cout) if vec else None
            out.append((f"conv_chw 1x1 {cin}->{cout} {act} {h}x{w} acc={acc} "
                        f"vec={vec} {tag}",
                        lambda uk, x=x, wt=wt, bias=bias, a=a, v=v, act=act:
                        conv_chw(x, wt, bias, a, v, k=1, act=act,
                                 use_kernels=uk)))
        out += [(f"resize_chw {what} {tag}", fn)
                for what, fn in _resize_forms(rnd, dt).items()]
        # the row-window form: shard 1 of 4 of a 64-row map -> 128 rows
        xs = rnd(2, 48, 64, 128).to(dt)
        _, hu, hd = shard_interp_bands(64, 128, 4, True)
        win = halo_exchange(list(xs.chunk(4, dim=2)), hu, hd)[1].contiguous()
        raws = rnd(2, 32, 32, 256).to(dt)
        st = [(rnd(48, 32, 1, 1, scale=0.2).to(dt), rnd(48, scale=0.1)),
              (rnd(48, 48, 1, 1, scale=0.2).to(dt), rnd(48, scale=0.1))]
        out.append((f"resize_chw shard 1/4 64x128->128x256 chain {tag}",
                    lambda uk, win=win, raws=raws, st=st: resize_chw(
                        win, (128, 256), acc_chain=(raws, st),
                        shard=(1, 4, 64), use_kernels=uk)))
    return out


def tile_sweep(torch, rnd, cuda_ms):
    """[{shape, tile, ms, bits_equal}] of every conv1x1_kernel tile at the
    path's 48 -> 48 (8x128x256) and 48 -> 19 (8x256x512) launches, each
    launched through the C entry with conv1x1_plan's layout for the tile."""
    import ctypes
    from segtpu_torch.kernels import chw_ops
    from segtpu_torch.kernels._build import load
    fn = load("conv_chw").segtpu_conv_chw
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p] * 2
    rows = []
    for shape, cout, act in CONV_CALLS[1:]:
        b, c, h, w = shape
        x = rnd(*shape).to(torch.bfloat16)
        wt = rnd(cout, c, 1, 1, scale=0.15).to(torch.bfloat16)
        bias = rnd(cout, scale=0.1)
        want = chw_ops.conv_chw(x, wt, bias, k=1, act=act, use_kernels=False)
        out = torch.empty_like(want)
        for tile in chw_ops.CONV1X1_TILES:
            p = chw_ops.conv1x1_plan(c, cout, 2, tile)
            plan = (ctypes.c_int * 7)(p.co, p.px, p.ng, p.kc, p.groups,
                                      p.smem, 1)

            def run(plan=plan):
                rc = fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), None,
                        None, out.data_ptr(), b, c, cout, h, w, 1, 1, 0,
                        chw_ops._ACT_CODE[act], 1, ctypes.addressof(plan),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"tile {tile}: CUDA error {rc}")
            run()
            same, _ = _bits(torch, out, want)
            row = dict(shape=list(shape), cout=cout, tile=list(tile),
                       ms=cuda_ms(run), bits_equal=same)
            rows.append(row)
            print(f"[tiles] {row}")
    return rows


def predict_ms(torch, cuda_ms) -> float:
    """ms of one b8 1024x2048 predict_batch, frames on the card."""
    import numpy as np
    from segtpu_torch.engine import Segmenter
    from segtpu_torch.models import ARCHS, create_segmenter
    model = create_segmenter(ARCHS["arch0"], 19,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    seg = Segmenter(model, device="cuda")
    frames = np.random.default_rng(3).integers(0, 256, (8, 1024, 2048, 3),
                                               dtype=np.uint8)
    x = torch.from_numpy(frames).cuda()
    return cuda_ms(lambda: seg.predict_batch(x), 10)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None):
    args = _args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("pw_resize_probe needs a CUDA card")
    import segtpu_torch
    from segtpu_torch.kernels import _build
    from segtpu_torch.scripts import cuda_ms, turns_ms
    t0 = time.perf_counter()
    _build.build(["conv_chw", "resize"])
    res = {"root": os.path.dirname(os.path.abspath(segtpu_torch.__file__)),
           "gpu": gpu_line(), "build_s": time.perf_counter() - t0,
           "calls": [], "forms": []}
    ok = True
    rnd = seeded(torch, 7)
    with torch.inference_mode():
        calls = path_calls(torch, rnd)
        for name, fn, lib, (nbytes, fma) in calls:
            same, err = _bits(torch, fn(True), fn(False))
            ok &= same
            t = turns_ms({"ms": lambda: fn(True), "library_ms": lib}, cuda_ms)
            row = dict(name=name, bits_equal=same, max_abs_err=err, **t,
                       bytes_ms=nbytes / 3.35e12 * 1e3,
                       fma_floor_ms=2 * fma / 59.5e12 * 1e3)
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
        if args.tiles:
            res["tiles"] = tiles = tile_sweep(torch, rnd, cuda_ms)
            ok &= all(r["bits_equal"] for r in tiles)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            for _, fn, _, _ in calls:
                fn(True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                for _, fn, _, _ in calls:
                    fn(True)
                torch.cuda.synchronize()
            res["profile"] = {
                e.key: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0)) / 1e3
                for e in p.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
            print(p.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=12))
    res["ok"] = bool(ok)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("root", "gpu", "ok")}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
