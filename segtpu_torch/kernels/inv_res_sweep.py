"""Time every tile of an inverted-residual kernel at the encoder's block
shapes, on the card.

    python3 -m segtpu_torch.kernels.inv_res_sweep [--kernel cuda_cores|tc]
        [--batch 8] [--hw 1024 2048]

For each of the 17 MobileNet-v2 blocks of a bf16 batch it launches the
kernel with every tile that fits: ``--kernel cuda_cores`` (the default)
the served ``inv_res_kernel`` with every (th, tw, mc) of ``_TILES`` whose
shared memory fits; ``--kernel tc`` the tensor-core ``inv_res_tc_kernel``
(``inv_res_tc_chw``) with every plan (th, tw, mc, mt, nt16) of
``inv_res_tc_plans``. It checks that every tile gives the same bits (no
sum order depends on the tile), times each with CUDA events, and prints
the fastest beside the tile the rule picks (``inv_res_tile``,
``inv_res_tc_plan``) and the other kernel at its own rule's tile, then the
fastest as a table literal: ``chw_ops._MEASURED_TILES`` and
``_MEASURED_TC_TILES`` hold the fastest of such runs. Writes
chiprun_out/inv_res_sweep_<kernel>.json.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from segtpu_torch.kernels.chw_ops import (_SMEM_LIMIT, _TILES, _inv_res_launch,
                                          _inv_res_tc_launch, _sm_count,
                                          _tile_ok, inv_res_smem,
                                          inv_res_tc_plan, inv_res_tc_plans,
                                          inv_res_tile)
from segtpu_torch.models.encoders import _MBV2_CFG

TABLES = {"cuda_cores": "_MEASURED_TILES", "tc": "_MEASURED_TC_TILES"}


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


def _tiles(kernel, cin, cmid, cout, ho, wo, st, batch, sms):
    """(every tile of ``kernel`` that fits, the rule's tile, launch)."""
    if kernel == "tc":
        return (inv_res_tc_plans(cin, cmid, cout, ho, wo, st),
                inv_res_tc_plan(cin, cmid, cout, ho, wo, st, batch,
                                sm_count=sms), _inv_res_tc_launch)
    tiles = [(th, tw, mc) for th, tw in _TILES if _tile_ok(th, tw, ho, wo)
             for mc in (64, 32, 16, 8, 4) if cmid % mc == 0
             and inv_res_smem(cin, mc, cout, th, tw, st, 2) <= _SMEM_LIMIT]
    return (tiles, inv_res_tile(cin, cmid, cout, ho, wo, st, 2, batch,
                                sm_count=sms), _inv_res_launch)


def sweep(kernel: str, batch: int, h: int, w: int):
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
                                     batch, sms)
        want = launch(*args, tile=rule, **kw).view(torch.int16)
        times = {}
        for tile in dict.fromkeys(tiles + [rule]):
            got = launch(*args, tile=tile, **kw)
            if not torch.equal(got.view(torch.int16), want):
                raise RuntimeError(f"block {i}: tile {tile} gives other bits "
                                   f"than tile {rule}")
            times[tile] = _ms(lambda: launch(*args, tile=tile, **kw))
        best = min(times, key=times.get)
        _, _, other_launch = _tiles(other, cin, cmid, cout, ho, wo, st, batch,
                                    sms)
        other_ms = _ms(lambda: other_launch(*args, **kw))
        rows.append({"block": i, "shape": [batch, cin, hi, wi], "cmid": cmid,
                     "cout": cout, "stride": st, "best": list(best),
                     "best_ms": times[best], "rule": list(rule),
                     "rule_ms": times[rule], f"{other}_ms": other_ms,
                     "all": {"x".join(map(str, k)): v
                             for k, v in sorted(times.items(),
                                                key=lambda kv: kv[1])}})
        print(f"block {i:2d} {cin}->{cmid}->{cout} s{st} {hi}x{wi}: best "
              f"{best} {times[best]:.4f} ms, rule {rule} "
              f"{times[rule]:.4f} ms, {other} {other_ms:.4f} ms")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(TABLES), default="cuda_cores")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(1024, 2048))
    a = ap.parse_args()
    rows = sweep(a.kernel, a.batch, *a.hw)
    other = "tc" if a.kernel == "cuda_cores" else "cuda_cores"
    print(f"{a.kernel}: sum best {sum(r['best_ms'] for r in rows):.4f} ms, "
          f"rule {sum(r['rule_ms'] for r in rows):.4f} ms; {other} "
          f"{sum(r[f'{other}_ms'] for r in rows):.4f} ms")
    print(f"{TABLES[a.kernel]} = {{" + ", ".join(dict.fromkeys(
        f"({r['shape'][1]}, {r['cmid']}, {r['cout']}, {r['stride']}): "
        f"{tuple(r['best'])}" for r in rows)) + "}")
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"inv_res_sweep_{a.kernel}.json")
    with open(path, "w") as f:
        json.dump({"gpu": torch.cuda.get_device_name(0), "kernel": a.kernel,
                   "batch": a.batch, "hw": a.hw, "blocks": rows}, f, indent=1)


if __name__ == "__main__":
    main()
