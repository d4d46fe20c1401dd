"""A/B of the single-rounding front against the production front
(counterpart: scripts/exp_front_kernel.py).

Arms, on the same seeded uint8 batch (default 8 x 1024 x 2048):

* ``single-round``: ``kernels.front_ab.front_single_round``, the
  experiment's fused front: bf16(u8 * bf16 scale + f32 bias), one
  rounding, [N, 12, H/2, W/2];
* ``production``: ``kernels.front.normalize_s2d_front``, the serving
  path's front (the product rounded to bf16, then a bf16 bias add);
* ``plain``: the single-round front's plain PyTorch twin.

The single-round kernel must equal its twin bit for bit. Against the
production front it differs by one bf16 ulp in a large share of the
elements, since the two round differently; the script prints the largest
difference and the share of equal elements, and each arm's time.

    python3 -m segtpu_torch.scripts.exp_front_kernel [h w]
"""

from __future__ import annotations

import numpy as np
import torch

from segtpu_torch.kernels.front import normalize_s2d_front
from segtpu_torch.kernels.front_ab import (front_single_round,
                                           front_single_round_plain)
from segtpu_torch.scripts import (bits_equal, device_arg, device_name,
                                  fmt_ms, timer, turns_ms)
from segtpu_torch.utils.helpers import resolve_device


def seeded_batch(n, h, w, dev, seed=0):
    """uint8 [n, h, w, 3] from numpy's RandomState(seed), as the script."""
    img = np.random.RandomState(seed).randint(0, 256, (n, h, w, 3), np.uint8)
    return torch.from_numpy(img).to(dev)


def compare(got, ref):
    """(largest |difference|, share of bit-equal elements)."""
    diff = (got.float() - ref.float()).abs()
    same = (got.view(torch.int16) == ref.view(torch.int16)).float().mean()
    return diff.max().item(), same.item()


def run(device="cuda", n=8, h=1024, w=2048, seed=0):
    dev = resolve_device(device)
    ms_of = timer(dev)
    img = seeded_batch(n, h, w, dev, seed)
    got = front_single_round(img)
    if not bits_equal(got, front_single_round_plain(img)):
        raise AssertionError("front_single_round differs from its plain twin")
    prod = normalize_s2d_front(img)
    err, same = compare(got, prod)
    arms = {"single-round": lambda: front_single_round(img),
            "production": lambda: normalize_s2d_front(img),
            "plain": lambda: front_single_round_plain(img)}
    ms = turns_ms(arms, ms_of)
    print(f"# device={device_name(dev)} b{n} {h}x{w}")
    print("single-round vs plain twin: bit-identical True")
    print(f"max |err| vs production front: {err} (bit-equal share {same!r})")
    for name, t in ms.items():
        print(f"{name}: {fmt_ms(t)}")
    return dict(device=device_name(dev), max_abs_err_vs_production=err,
                equal_share_vs_production=same, ms=ms)


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0], argv,
                      hw=dict(nargs="*", type=int, default=[1024, 2048]))
    run(args.device, h=args.hw[0], w=args.hw[1])


if __name__ == "__main__":
    main()
