"""Time the deeplab family's kernels on the card at the shapes of a b8
1024x2048 call (the output stride 16 map is 64x128 a frame).

    python3 segtpu_torch/kernels/aspp_probe.py [--sweep N] [--batch 8]

Head: ``aspp_chw``'s two launches (the 1x1 and the three atrous branches,
320 -> 4 x 256; the projection 1024 -> 256 with the pooled vector) on
seeded bf16 operands, each against its plain twin (share of bit-identical
elements, worst error as a share of max(|ref|, 1)), timed by CUDA events
beside their bound (``BOUND``: FLOPs at 989 TFLOP/s, bytes at 3.35 TB/s)
and the library's bf16 ``F.conv2d`` of the same convolutions.

``--sweep N``: the four stride-16 blocks of the encoder (96 -> 160 at
rate 1, 160 -> 160 twice and 160 -> 320 at rate 2), each with the ``N``
plans ``inv_res_cost`` rates fastest and the rule's, every plan's output
held to the twin's bits, and the fastest printed as table literals
(``chw_ops._MEASURED_PLANS``). Prints one JSON line and writes
it to chiprun_out/aspp_probe.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
# the stride-16 blocks: (cin, t, cout, rate, residual)
ATROUS_BLOCKS = ((96, 6, 160, 1, False), (160, 6, 160, 2, True),
                 (160, 6, 160, 2, True), (160, 6, 320, 2, False))


def _ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _agree(torch, got, want) -> dict:
    g, w = got.float(), want.float()
    return {"bit_identical": (got.view(torch.int16) == want.view(torch.int16))
            .float().mean().item(),
            "worst": ((g - w).abs() / w.abs().clamp_min(1.0)).max().item()}


def head(torch, batch: int, h: int, w: int) -> dict:
    from segtpu_torch.kernels.aspp import aspp_chw
    from segtpu_torch.kernels.chw_ops import pack_weights
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dt=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    f = rnd(batch, 320, h, w).relu()
    dil = [1, 6, 12, 18]
    ws = [rnd(256, 320, 1, 1, scale=320 ** -0.5)] + [
        rnd(256, 320, 3, 3, scale=2880 ** -0.5) for _ in dil[1:]]
    bs = [rnd(256, scale=0.1, dt=torch.float32) for _ in dil]
    wps = [pack_weights(wt) for wt in ws]
    wp = rnd(256, 1024, 1, 1, scale=1024 ** -0.5)
    bp = rnd(256, scale=0.1, dt=torch.float32)
    vec = rnd(batch, 256, scale=0.1, dt=torch.float32)
    out = {}
    with torch.inference_mode():
        cat = aspp_chw(f, ws, bs, dil, packed=wps)
        out["branches"] = _agree(torch, cat, aspp_chw(
            f, ws, bs, dil, use_kernels=False))
        y = aspp_chw(cat, [wp], [bp], [1], vec, packed=[pack_weights(wp)])
        out["projection"] = _agree(torch, y, aspp_chw(
            cat, [wp], [bp], [1], vec, use_kernels=False))
        pwp = [pack_weights(wp)]
        out["branches_ms"] = _ms(torch, lambda: aspp_chw(
            f, ws, bs, dil, packed=wps))
        out["projection_ms"] = _ms(torch, lambda: aspp_chw(
            cat, [wp], [bp], [1], vec, packed=pwp))
        out["plain_ms"] = _ms(torch, lambda: aspp_chw(
            f, ws, bs, dil, use_kernels=False), iters=1)

        def library():
            c = torch.cat([F.conv2d(f, wt, b.to(bf), padding=d * (
                wt.shape[-1] // 2), dilation=d).relu()
                for wt, b, d in zip(ws, bs, dil)], 1)
            return (F.conv2d(c, wp, bp.to(bf)) + vec.to(bf)[:, :, None, None]
                    ).relu()
        out["library_ms"] = _ms(torch, library)
    px = batch * h * w
    flop = 2.0 * px * 256 * (320 + 3 * 2880 + 1024)
    nbytes = 2.0 * (f.numel() + 2 * cat.numel() + y.numel()
                    + sum(wt.numel() for wt in ws) + wp.numel())
    out["flop"], out["bytes"] = flop, nbytes
    out["bound_ms"] = 1e3 * max(flop / BF16_FLOP_PER_S,
                                nbytes / HBM_BYTES_PER_S)
    out["ms"] = out["branches_ms"] + out["projection_ms"]
    out["tflop_per_s"] = flop / out["ms"] / 1e9
    return out


def sweep(torch, batch: int, h: int, w: int, top: int) -> dict:
    from segtpu_torch.kernels.chw_ops import (_inv_res_launch, _sm_count,
                                              inv_res_chw_plain, inv_res_cost,
                                              inv_res_plan, inv_res_plans,
                                              pack_inv_res)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    sms = _sm_count(dev)
    rows = {}
    for cin, t, cout, rate, residual in ATROUS_BLOCKS:
        cmid = cin * t

        def rnd(*shape, dt=torch.bfloat16):
            return (torch.randn(shape, generator=g, device=dev) * 0.1).to(dt)
        args = (rnd(batch, cin, h, w), rnd(cmid, cin, 1, 1),
                rnd(cmid, dt=torch.float32), rnd(cmid, 1, 3, 3,
                                                 dt=torch.float32),
                rnd(cmid, dt=torch.float32), rnd(cout, cmid, 1, 1),
                rnd(cout, dt=torch.float32))
        want = inv_res_chw_plain(*args, residual=residual, dilation=rate)
        kw = dict(stride=1, residual=residual, what="probe", dilation=rate,
                  packed=pack_inv_res(args[1], args[5], torch.bfloat16))
        plans = sorted(inv_res_plans(cin, cmid, cout, h, w, 1, torch.bfloat16,
                                     True, dilation=rate),
                       key=lambda p: inv_res_cost(p, cin, cmid, cout, h, w, 1,
                                                  batch, True, sms,
                                                  dilation=rate))[:top]
        rule = inv_res_plan(cin, cmid, cout, h, w, 1, torch.bfloat16, batch,
                            True, sm_count=sms, dilation=rate)
        times = {}
        for plan in dict.fromkeys(plans + [rule]):
            got = _inv_res_launch(*args, tile=plan, **kw)
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise RuntimeError(f"{cin}->{cout} rate {rate}: plan {plan} "
                                   f"gives other bits than its twin")
            times[tuple(plan[:5])] = _ms(torch, lambda: _inv_res_launch(
                *args, tile=plan, **kw))
        best = min(times, key=times.get)
        key = f"{cin},{cmid},{cout},1,{rate}"
        rows[key] = {"best": list(best), "best_ms": times[best],
                     "rule": list(rule[:5]),
                     "rule_ms": times[tuple(rule[:5])], "timed": len(times)}
        print(f"[sweep] ({key}): best {best} {times[best]:.4f} ms, rule "
              f"{tuple(rule[:5])} {times[tuple(rule[:5])]:.4f} ms of "
              f"{len(times)}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from segtpu_torch.kernels import _build
    _build.build(("inv_res", "aspp"))
    for name in ("inv_res", "aspp"):
        log = f"{_build.library_path(name)}.log"
        if os.path.exists(log):
            for line in open(log).read().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")
    h, w = 1024 // 16, 2048 // 16
    res = {"gpu": torch.cuda.get_device_name(0),
           "head": head(torch, args.batch, h, w)}
    print(f"[head] {json.dumps(res['head'])}", flush=True)
    if args.sweep:
        res["sweep"] = sweep(torch, args.batch, h, w, args.sweep)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "aspp_probe.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
