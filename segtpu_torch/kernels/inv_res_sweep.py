"""Time every output tile and mid-channel chunk of the inverted-residual
kernels at the encoder's block shapes, on the card.

    python3 -m segtpu_torch.kernels.inv_res_sweep [--batch 8] [--hw 1024 2048]

For each of the 17 MobileNet-v2 blocks of a bf16 batch it launches
``inv_res_chw``/``inv_res_s2_chw`` with every (th, tw, mc) whose shared
memory fits, times each with CUDA events, and prints the fastest beside
the tile ``inv_res_tile`` picks (its ``_MEASURED_TILES`` table holds the
fastest of such a run). Writes chiprun_out/inv_res_sweep.json.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from segtpu_torch.kernels.chw_ops import (_SMEM_LIMIT, _TILES, _inv_res_launch,
                                          _sm_count, _tile_ok, inv_res_smem,
                                          inv_res_tile)
from segtpu_torch.models.encoders import _MBV2_CFG


def block_shapes(h: int, w: int):
    """(cin, cmid, cout, stride, h_in, w_in, expand) of the 17 blocks for
    an h x w frame (the stem halves it)."""
    out, cin, h, w = [], 32, h // 2, w // 2
    for t, c, n, s in _MBV2_CFG:
        for i in range(n):
            st = s if i == 0 else 1
            out.append((cin, cin * t, c, st, h, w, t != 1))
            h, w, cin = h // st, w // st, c
    return out


def _ms(fn, iters=5):
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


def sweep(batch: int, h: int, w: int):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = _sm_count(dev)
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
        res = st == 1 and cin == cout
        times = {}
        for th, tw in _TILES:
            if not _tile_ok(th, tw, ho, wo):
                continue
            for mc in (64, 32, 16, 8, 4):
                if cmid % mc or inv_res_smem(cin, mc, cout, th, tw, st,
                                             2) > _SMEM_LIMIT:
                    continue
                times[(th, tw, mc)] = _ms(lambda: _inv_res_launch(
                    *args, stride=st, residual=res, what="sweep",
                    tile=(th, tw, mc)))
        best = min(times, key=times.get)
        rule = inv_res_tile(cin, cmid, cout, ho, wo, st, 2, batch,
                            sm_count=sms)
        rows.append({"block": i, "shape": [batch, cin, hi, wi], "cmid": cmid,
                     "cout": cout, "stride": st, "best": list(best),
                     "best_ms": times[best], "rule": list(rule),
                     "rule_ms": times[tuple(rule)],
                     "all": {f"{k[0]}x{k[1]}/{k[2]}": v
                             for k, v in sorted(times.items(),
                                                key=lambda kv: kv[1])}})
        print(f"block {i:2d} {cin}->{cmid}->{cout} s{st} {hi}x{wi}: best "
              f"{best} {times[best]:.4f} ms, rule {tuple(rule)} "
              f"{times[tuple(rule)]:.4f} ms")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(1024, 2048))
    a = ap.parse_args()
    rows = sweep(a.batch, *a.hw)
    print(f"sum best {sum(r['best_ms'] for r in rows):.4f} ms, rule "
          f"{sum(r['rule_ms'] for r in rows):.4f} ms")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "inv_res_sweep.json"), "w") as f:
        json.dump({"gpu": torch.cuda.get_device_name(0), "batch": a.batch,
                   "hw": a.hw, "blocks": rows}, f, indent=1)


if __name__ == "__main__":
    main()
