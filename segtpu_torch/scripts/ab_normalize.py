"""A/B of the channels-last normalize + space-to-depth kernel against the
production front (counterpart: scripts/ab_normalize.py).

Arms, on the same seeded uint8 batch (default 8 x 1024 x 2048):

* ``pallas``: ``kernels.front_ab.normalize_s2d_nhwc``, the experiment's
  fused kernel: bf16((u8 - mean * 255) * (1 / (std * 255))),
  [N, H/2, W/2, 12];
* ``current``: the production front, ``kernels.front.normalize_s2d_front``
  ([N, 12, H/2, W/2]; compared after a permute to channels last);
* ``plain``: the NHWC kernel's plain PyTorch twin.

The experiment's ``barrier``, ``perm-matmul`` and ``perm2`` arms are XLA
programs built around TPU layout tricks (an optimization barrier that
forces the transpose in uint8, and permutation matmuls on the MXU), not
Pallas kernels; they have no counterpart here and are printed as not
ported. The NHWC kernel must equal its twin bit for bit; against the
production front it differs by up to a few bf16 ulp, since the two
compute the normalization differently.

    python3 -m segtpu_torch.scripts.ab_normalize
"""

from __future__ import annotations

import torch

from segtpu_torch.kernels.front import normalize_s2d_front
from segtpu_torch.kernels.front_ab import (normalize_s2d_nhwc,
                                           normalize_s2d_nhwc_plain)
from segtpu_torch.scripts import (bits_equal, device_arg, device_name,
                                  fmt_ms, timer, turns_ms)
from segtpu_torch.scripts.exp_front_kernel import compare, seeded_batch
from segtpu_torch.utils.helpers import resolve_device

NOT_PORTED = ("barrier", "perm-matmul", "perm2")


def run(device="cuda", n=8, h=1024, w=2048, seed=0):
    dev = resolve_device(device)
    ms_of = timer(dev)
    img = seeded_batch(n, h, w, dev, seed)
    got = normalize_s2d_nhwc(img)
    if not bits_equal(got, normalize_s2d_nhwc_plain(img)):
        raise AssertionError("normalize_s2d_nhwc differs from its plain twin")
    prod = normalize_s2d_front(img).permute(0, 2, 3, 1)
    err, same = compare(got, prod.contiguous())
    arms = {"pallas": lambda: normalize_s2d_nhwc(img),
            "current": lambda: normalize_s2d_front(img),
            "plain": lambda: normalize_s2d_nhwc_plain(img)}
    ms = turns_ms(arms, ms_of)
    print(f"# device={device_name(dev)} b{n} {h}x{w}")
    print("pallas vs plain twin: bit-identical True")
    print(f"max |err| vs current front: {err} (bit-equal share {same!r})")
    for name, t in ms.items():
        print(f"{name:8s} {fmt_ms(t)}")
    for name in NOT_PORTED:
        print(f"{name:8s} not ported: an XLA program built around TPU layout "
              f"tricks, not a Pallas kernel")
    return dict(device=device_name(dev), max_abs_err_vs_production=err,
                equal_share_vs_production=same, ms=ms)


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0], argv)
    run(args.device)


if __name__ == "__main__":
    main()
