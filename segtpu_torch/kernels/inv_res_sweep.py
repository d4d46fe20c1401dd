"""Time the inverted-residual kernels at the encoder's block shapes, on the
card.

    python3 segtpu_torch/kernels/inv_res_sweep.py [--kernel cuda_cores|tc]
        [--top N] [--batch 8] [--hw 1024 2048]
    python3 segtpu_torch/kernels/inv_res_sweep.py --predict [--root DIR]
        [--out FILE]

(``python3 -m segtpu_torch.kernels.inv_res_sweep`` runs the same, but
always on this checkout's package.)

Plans: for each of the 17 MobileNet-v2 blocks of a bf16 batch it launches
the kernel with many plans: ``--kernel cuda_cores`` (the default) the
served ``inv_res_kernel`` with the ``--top`` plans of ``inv_res_plans``
that ``inv_res_cost`` rates fastest (default 200, 0 for all) and the plan
``inv_res_plan`` picks; ``--kernel tc`` the tensor-core
``inv_res_tc_kernel`` with every plan of ``inv_res_tc_plans``. It checks
that every plan gives its plain twin's bits (``cuda_cores``) or the same
bits as the rule's plan (``tc``): no sum order depends on the plan. It
times each with CUDA events and prints the fastest beside the rule's plan
and the other kernel at its own rule's, then the fastest as a table
literal (for a shape that repeats, the plan with the least time summed
over its blocks): ``chw_ops._MEASURED_PLANS`` and ``_MEASURED_TC_TILES``
hold such runs' tables. Writes chiprun_out/inv_res_sweep_<kernel>.json.

``--predict``: the served encoder's 17 blocks (arch0's encoder folded in
bf16, random weights from seed 0) on a seeded b8 1024x2048 batch, each
block fed the last one's output: each stage's time through the served
block, in turns with its cuDNN yardstick (the expand, depthwise and
project as three ``F.conv2d``), its f32 FMA floor (the products as f32
multiply-adds at 59.5 TFLOP/s, the rate ``fmaf`` chains reach on an H100)
without and with the expand's halo at the plan's tiles (this checkout's
plan), its bits against the plain twin; the summed ``inv_res_chw`` and
``inv_res_s2_chw`` rows; ``Segmenter.predict_batch`` (CUDA events over 10
calls). ``--root`` imports ``segtpu_torch`` from another checkout (a
parent commit unpacked under ``archive_check/``), so one call can time
parent and change in turns: this mode calls only what both have. Prints
one JSON line and writes it to ``--out`` (default
chiprun_out/inv_res_predict.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

TABLES = {"cuda_cores": "_MEASURED_PLANS", "tc": "_MEASURED_TC_TILES"}
F32_FMA_FLOP_PER_S = 59.5e12   # fmaf chains on an H100 (exp_vpu_floor)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(TABLES), default="cuda_cores")
    ap.add_argument("--top", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(1024, 2048))
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "inv_res_predict.json"))
    return ap.parse_args(argv)


def block_shapes(h: int, w: int):
    """(cin, cmid, cout, stride, h_in, w_in, expand) of the 17 blocks for
    an h x w frame (the stem halves it)."""
    from segtpu_torch.models.encoders import _MBV2_CFG
    out, cin, h, w = [], 32, h // 2, w // 2
    for t, c, n, s in _MBV2_CFG:
        for i in range(n):
            st = s if i == 0 else 1
            out.append((cin, cin * t, c, st, h, w, t != 1))
            h, w, cin = h // st, w // st, c
    return out


def fma_floor_ms(cin, cmid, cout, stride, batch, h, w, expand, plan=None):
    """ms of a block's products (expand and project) as f32 multiply-adds
    at 59.5 TFLOP/s; with ``plan`` (th, tw, ...) the expand over every
    tile's whole window (the halo recomputed), else over the input once."""
    from segtpu_torch.kernels.chw_ops import _cdiv, inv_res_window
    ho, wo = h // stride, w // stride
    px = h * w
    if plan is not None:
        wh, ww = inv_res_window(plan[0], plan[1], stride)
        px = _cdiv(ho, plan[0]) * _cdiv(wo, plan[1]) * wh * ww
    fma = batch * (px * cin * cmid * expand + ho * wo * cmid * cout)
    return 2 * fma / F32_FMA_FLOP_PER_S * 1e3


def _ms(torch, fn, iters=5):
    for _ in range(2):
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


def _tiles(kernel, cin, cmid, cout, ho, wo, st, batch, sms, top=0):
    """(the plans of ``kernel`` to time, the rule's plan, launch): for
    ``cuda_cores`` the bf16 block's ``top`` plans ``inv_res_cost`` rates
    fastest (all for 0) and the rule's (the block has an expand unless
    cmid == cin, MobileNet-v2's t = 1); ``tc`` every plan."""
    import torch
    from segtpu_torch.kernels.chw_ops import (
        _inv_res_launch, _inv_res_tc_launch, inv_res_cost, inv_res_plan,
        inv_res_plans, inv_res_tc_plan, inv_res_tc_plans)
    if kernel == "tc":
        return (inv_res_tc_plans(cin, cmid, cout, ho, wo, st),
                inv_res_tc_plan(cin, cmid, cout, ho, wo, st, batch,
                                sm_count=sms), _inv_res_tc_launch)
    expand = cmid != cin
    plans = sorted(inv_res_plans(cin, cmid, cout, ho, wo, st,
                                 torch.bfloat16, expand),
                   key=lambda p: inv_res_cost(p, cin, cmid, cout, ho, wo, st,
                                              batch, expand, sms))
    rule = inv_res_plan(cin, cmid, cout, ho, wo, st, torch.bfloat16, batch,
                        expand, sm_count=sms)
    plans = plans[:top] if top else plans
    return (plans + ([rule] if rule not in plans else []), rule,
            _inv_res_launch)


def sweep(torch, kernel: str, batch: int, h: int, w: int, top: int):
    from segtpu_torch.kernels.chw_ops import _sm_count
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = _sm_count(dev)
    other = "tc" if kernel == "cuda_cores" else "cuda_cores"
    rows = []
    for i, (cin, cmid, cout, st, hi, wi, expand) in enumerate(
            block_shapes(h, w)):
        def rnd(*shape, dt=torch.bfloat16):
            return (torch.randn(shape, generator=g, device=dev) * 0.1).to(dt)
        x = rnd(batch, cin, hi, wi)
        args = (x, rnd(cmid, cin, 1, 1) if expand else None,
                rnd(cmid, dt=torch.float32) if expand else None,
                rnd(cmid, 1, 3, 3, dt=torch.float32),
                rnd(cmid, dt=torch.float32), rnd(cout, cmid, 1, 1),
                rnd(cout, dt=torch.float32))
        ho, wo = hi // st, wi // st
        kw = dict(stride=st, residual=st == 1 and cin == cout, what="sweep")
        tiles, rule, launch = _tiles(kernel, cin, cmid, cout, ho, wo, st,
                                     batch, sms, top)
        if kernel == "cuda_cores":
            from segtpu_torch.kernels.chw_ops import (_inv_res_plain,
                                                      pack_inv_res)
            want = _inv_res_plain(*args, stride=st, residual=kw["residual"])
            # the weights packed once, as the folded encoder does
            kw["packed"] = pack_inv_res(args[1], args[5], torch.bfloat16)
        else:
            want = launch(*args, tile=rule, **kw)
        want = want.view(torch.int16)
        times = {}
        for tile in dict.fromkeys(tiles):
            got = launch(*args, tile=tile, **kw)
            if not torch.equal(got.view(torch.int16), want):
                ref = "its twin" if kernel == "cuda_cores" else rule
                raise RuntimeError(f"block {i}: plan {tile} gives other bits "
                                   f"than {ref}")
            times[tuple(tile)] = _ms(torch, lambda: launch(*args, tile=tile,
                                                            **kw))
        best = min(times, key=times.get)
        _, other_rule, other_launch = _tiles(other, cin, cmid, cout, ho, wo,
                                             st, batch, sms, 1)
        okw = {k: v for k, v in kw.items() if k != "packed"}
        other_ms = _ms(torch, lambda: other_launch(*args, **okw))
        rows.append({"block": i, "shape": [batch, cin, hi, wi], "cmid": cmid,
                     "cout": cout, "stride": st, "best": list(best),
                     "best_ms": times[best], "rule": list(rule),
                     "rule_ms": times[tuple(rule)], f"{other}_ms": other_ms,
                     "all": {"x".join(map(str, k)): v
                             for k, v in sorted(times.items(),
                                                key=lambda kv: kv[1])}})
        print(f"block {i:2d} {cin}->{cmid}->{cout} s{st} {hi}x{wi}: best "
              f"{best} {times[best]:.4f} ms of {len(times)}, rule "
              f"{tuple(rule)} {times[tuple(rule)]:.4f} ms, {other} "
              f"{other_ms:.4f} ms", flush=True)
    return rows


def table(rows) -> dict:
    """{(cin, cmid, cout, stride): plan}: for each block shape the plan
    (its first 5 ints, a table entry) with the least time summed over the
    shape's blocks, of the plans timed at every one of them."""
    sums, seen = {}, {}
    for r in rows:
        key = (r["shape"][1], r["cmid"], r["cout"], r["stride"])
        seen[key] = seen.get(key, 0) + 1
        for plan, ms in r["all"].items():
            plan = tuple(int(v) for v in plan.split("x"))[:5]
            got = sums.setdefault(key, {}).setdefault(plan, [0, 0.0])
            got[0] += 1
            got[1] += ms
    return {key: min((p for p, (k, _) in plans.items() if k == seen[key]),
                     key=lambda p: plans[p][1])
            for key, plans in sums.items()}


def predict(torch, batch: int, h: int, w: int) -> dict:
    """The served encoder's stages and ``predict_batch`` (see the module
    doc): {stages: [...], inv_res_chw_ms, ..., predict_batch_ms}."""
    import numpy as np
    import torch.nn.functional as F
    from segtpu_torch.kernels import chw_ops
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.kernels.pw_resize_probe import predict_ms
    from segtpu_torch.models import ARCHS, create_segmenter
    from segtpu_torch.models.fast_encoder import fold_encoder
    from segtpu_torch.scripts import cuda_ms, turns_ms
    model = create_segmenter(ARCHS["arch0"], 19,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    enc = fold_encoder(model.encoder, torch.bfloat16).to("cuda")
    frames = np.random.default_rng(3).integers(0, 256, (batch, h, w, 3),
                                               dtype=np.uint8)
    sms = chw_ops._sm_count(torch.device("cuda"))
    stages, sums = [], {}
    with torch.inference_mode():
        y = enc.stem(normalize_s2d_front(torch.from_numpy(frames).cuda()))
        for i, blk in enumerate(enc.blocks):
            b, cin, hi, wi = y.shape
            cmid, cout = blk.w_dw.shape[0], blk.w_proj.shape[0]
            st, expand = blk.stride, blk.w_exp is not None

            def lib(x=y, blk=blk):
                dt = x.dtype
                if blk.w_exp is not None:
                    x = F.conv2d(x, blk.w_exp, blk.b_exp.to(dt))
                x = F.conv2d(x, blk.w_dw.to(dt), blk.b_dw.to(dt),
                             stride=blk.stride, padding=1,
                             groups=x.shape[1])
                return F.conv2d(x, blk.w_proj, blk.b_proj.to(dt))
            got = blk(y, True)
            want = blk(y, False)
            same = bool(torch.equal(got.view(torch.int16),
                                    want.view(torch.int16)))
            t = turns_ms({"ms": lambda: blk(y, True), "library_ms": lib},
                         cuda_ms)
            plan = None
            if hasattr(chw_ops, "inv_res_plan"):   # this checkout's plan
                plan = chw_ops.inv_res_plan(
                    cin, cmid, cout, hi // st, wi // st, st, torch.bfloat16,
                    b, expand, sm_count=sms)
            name = "inv_res_s2_chw" if st == 2 else "inv_res_chw"
            row = dict(block=i, name=name, shape=[b, cin, hi, wi], cmid=cmid,
                       cout=cout, bits_equal=same, **t,
                       fma_floor_ms=fma_floor_ms(cin, cmid, cout, st, b, hi,
                                                 wi, expand),
                       fma_floor_halo_ms=None if plan is None else
                       fma_floor_ms(cin, cmid, cout, st, b, hi, wi, expand,
                                    plan),
                       plan=None if plan is None else list(plan))
            stages.append(row)
            for k in ("ms", "library_ms"):
                sums[f"{name}_{k}"] = sums.get(f"{name}_{k}", 0.0) + row[k]
            print(json.dumps(row), flush=True)
            y = got
        sums["blocks_ms"] = sum(r["ms"] for r in stages)
        sums["library_blocks_ms"] = sum(r["library_ms"] for r in stages)
        sums["predict_batch_ms"] = predict_ms(torch, cuda_ms)
    return dict(stages=stages, **sums)


def main(argv=None):
    args = _args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("inv_res_sweep needs a CUDA card")
    import segtpu_torch
    from segtpu_torch.kernels import _build
    from segtpu_torch.kernels.pw_resize_probe import gpu_line
    t0 = time.perf_counter()
    lib = _build.build(["inv_res"])["inv_res"]
    build_s = time.perf_counter() - t0
    log = f"{lib}.log"
    ptxas = [ln.strip() for ln in open(log)] if os.path.exists(log) else []
    for ln in ptxas:
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"[build] {ln}")
    root = os.path.dirname(os.path.abspath(segtpu_torch.__file__))
    if args.predict:
        res = dict(root=root, gpu=gpu_line(), build_s=build_s,
                   **predict(torch, args.batch, *args.hw))
        print(f"[predict] blocks {res['blocks_ms']:.4f} ms (cuDNN "
              f"{res['library_blocks_ms']:.4f}), predict_batch "
              f"{res['predict_batch_ms']:.4f} ms")
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps({k: v for k, v in res.items() if k != "stages"}))
        sys.exit(0 if all(r["bits_equal"] for r in res["stages"]) else 1)
    rows = sweep(torch, args.kernel, args.batch, *args.hw, args.top)
    other = "tc" if args.kernel == "cuda_cores" else "cuda_cores"
    print(f"{args.kernel}: sum best {sum(r['best_ms'] for r in rows):.4f} ms, "
          f"rule {sum(r['rule_ms'] for r in rows):.4f} ms; {other} "
          f"{sum(r[f'{other}_ms'] for r in rows):.4f} ms")
    # _MEASURED_PLANS keys its shapes by the depthwise rate too
    rate = (1,) if args.kernel == "cuda_cores" else ()
    print(f"{TABLES[args.kernel]} = {{" + ", ".join(
        f"{key + rate}: {plan}" for key, plan in table(rows).items())
        + "}")
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"inv_res_sweep_{args.kernel}.json")
    with open(path, "w") as f:
        json.dump({"gpu": gpu_line(), "kernel": args.kernel,
                   "batch": args.batch, "hw": args.hw, "build_s": build_s,
                   "ptxas": ptxas, "blocks": rows}, f, indent=1)


if __name__ == "__main__":
    main()
