"""The train BatchNorm kernels (``kernels/bn_train.py``) on the card, at
every BatchNorm of arch0's train step with aux heads: each distinct
(shape, activation) of the step at b64 512x512 in f32, as the training
cell runs it, the
kernel route's forward and backward against the plain twin's, by device
time (torch.profiler, the kernels' own time summed) and beside the
bytes bound (3 passes forward, 5 backward, each element once a pass at
3.35 TB/s); then the step's sums over its 94 calls.

    python3 segtpu_torch/kernels/bn_train_probe.py [--out FILE]

The shapes come from a spy on ``bn_act_train`` over one CPU forward of
the model at 1x512x512. Prints the build's register and spill report,
one JSON row a shape, then one JSON line of the sums (the card's name
and power limit in it), written to ``--out`` (default
chiprun_out/bn_train_probe.json).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = 64
REPS = 5      # profiled calls a measurement


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "bn_train_probe.json"))
    return ap.parse_args(argv)


def step_calls(torch):
    """Counter of (C, H, W, act) over the train BatchNorms of arch0 with
    aux heads at 512x512."""
    from segtpu_torch.kernels import bn_train as bnk
    from segtpu_torch.models import ARCHS, create_segmenter
    model = create_segmenter(ARCHS["arch0"], 19, aux=True, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    calls = collections.Counter()
    real = bnk.bn_act_train

    def spy(y, scale, bias, mean, var, act):
        calls[tuple(y.shape[1:]) + (act,)] += 1
        return real(y, scale, bias, mean, var, act)

    bnk.bn_act_train = spy
    try:
        with torch.no_grad():
            model.train()(torch.zeros(1, 3, 512, 512), with_aux=True)
    finally:
        bnk.bn_act_train = real
    return calls


def device_ms(torch, fn, reps: int = REPS) -> float:
    """Device ms a call of ``fn``: its kernels' time summed (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum((getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))
               for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def shape_row(torch, shape, act) -> dict:
    """Forward and backward device ms of both routes at one shape."""
    from segtpu_torch.kernels import bn_train as bnk
    from segtpu_torch.scripts import bound_ms
    c = shape[1]
    g = torch.Generator(device="cuda").manual_seed(c)
    y = torch.randn(shape, generator=g, device="cuda")
    dy = torch.randn(shape, generator=g, device="cuda")
    params = [torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")]
    buffers = [torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")]
    routes = {"kernel": bnk._BnActTrain.apply,
              "plain": bnk.bn_act_train_plain}
    row = {"shape": list(shape), "act": act,
           "plan": bnk.bn_plan(shape, y.element_size(), True)._asdict()}
    for route, fn in routes.items():
        ya = y.clone().requires_grad_()
        pa = [t.clone().requires_grad_() for t in params]

        def forward():
            with torch.no_grad():
                fn(y, *params, *buffers, act)

        def both():
            out = fn(ya, *pa, *buffers, act)
            torch.autograd.grad(out, (ya, *pa), dy)

        fwd = device_ms(torch, forward)
        row[f"{route}_forward_ms"] = fwd
        row[f"{route}_backward_ms"] = device_ms(torch, both) - fwd
    elems = y.numel() * y.element_size()
    row["bound_forward_ms"] = bound_ms(3 * elems)[0]
    row["bound_backward_ms"] = bound_ms(5 * elems)[0]
    return row


def main(argv=None):
    args = _args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("bn_train_probe needs a CUDA card")
    from segtpu_torch.kernels import _build
    from segtpu_torch.kernels.pw_resize_probe import gpu_line
    lib = _build.build(["bn_train"])["bn_train"]
    if os.path.exists(f"{lib}.log"):
        for ln in open(f"{lib}.log"):
            if "registers" in ln or "spill" in ln or "stack" in ln:
                print(f"[build] {ln.strip()}")
    calls = step_calls(torch)
    keys = ("kernel_forward_ms", "kernel_backward_ms", "plain_forward_ms",
            "plain_backward_ms", "bound_forward_ms", "bound_backward_ms")
    sums = dict.fromkeys(keys, 0.0)
    rows = []
    for (c, h, w, act), count in sorted(calls.items()):
        row = shape_row(torch, (BATCH, c, h, w), act)
        row["calls"] = count
        rows.append(row)
        print(json.dumps(row))
        for k in keys:
            sums[k] += count * row[k]
    res = {"gpu": gpu_line(), "batch": BATCH, "dtype": "float32",
           "calls": sum(calls.values()), "shapes": len(calls), **sums,
           "rows": rows}
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
