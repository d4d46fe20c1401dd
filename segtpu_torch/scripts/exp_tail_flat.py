"""A/B of the classifier-fused tail against the port's chain of the
classifier kernel and the production tail (counterpart:
scripts/exp_tail_flat.py).

The chain writes the [B, K, h, w] bf16 logits to device memory and reads
them back; the fused tail (``kernels.tail_flat.clf_upsample_argmax``)
applies the [K, C] classifier to the decoder's feature map itself. Arms,
on the same seeded features (default b8, 48 channels, 256 x 512 ->
1024 x 2048, K = 19; the script's seeds):

* ``fused``: ``clf_upsample_argmax``;
* ``chain``: ``conv_chw`` (k = 1, the classifier) then ``upsample_argmax``;
* ``plain``: the fused tail's plain PyTorch twin.

The fused kernel must equal its twin bit for bit. Its mask agrees with
the chain's on a share just below 1, by construction: the experiment
rounds the W-pass weights to bf16, the production tail keeps them in f32.

    python3 -m segtpu_torch.scripts.exp_tail_flat [h w K]
"""

from __future__ import annotations

import numpy as np
import torch

from segtpu_torch.kernels.chw_ops import conv_chw
from segtpu_torch.kernels.tail_flat import (clf_upsample_argmax,
                                            clf_upsample_argmax_plain)
from segtpu_torch.kernels.upsample_argmax import upsample_argmax
from segtpu_torch.scripts import (bits_equal, device_arg, device_name,
                                  fmt_ms, timer, turns_ms)
from segtpu_torch.utils.helpers import resolve_device


def tail_inputs(b, cin, h, w, k, dev):
    """The script's seeded inputs: features RandomState(0) * 0.5 in bf16,
    classifier RandomState(5): weights * 0.3 in bf16, bias * 0.1 in f32."""
    feat = np.random.RandomState(0).randn(b, cin, h, w) * 0.5
    rng = np.random.RandomState(5)
    wclf = rng.randn(k, cin) * 0.3
    bclf = (rng.randn(k, 1) * 0.1).astype(np.float32)[:, 0]
    return (torch.from_numpy(feat).to(dev, torch.bfloat16),
            torch.from_numpy(wclf).to(dev, torch.bfloat16),
            torch.from_numpy(bclf).to(dev))


def chain(feat, wclf, bclf, out_hw):
    """The port's two-kernel chain: the 1x1 classifier, then the tail."""
    logits = conv_chw(feat, wclf[:, :, None, None], bclf, k=1, act="none")
    return upsample_argmax(logits, out_hw)


def run(device="cuda", b=8, cin=48, h=256, w=512, k=19):
    dev = resolve_device(device)
    ms_of = timer(dev)
    feat, wclf, bclf = tail_inputs(b, cin, h, w, k, dev)
    out_hw = (4 * h, 4 * w)
    got = clf_upsample_argmax(feat, wclf, bclf, out_hw)
    if not bits_equal(got, clf_upsample_argmax_plain(feat, wclf, bclf, out_hw)):
        raise AssertionError("clf_upsample_argmax differs from its plain twin")
    agree = (got == chain(feat, wclf, bclf, out_hw)).float().mean().item()
    arms = {"fused": lambda: clf_upsample_argmax(feat, wclf, bclf, out_hw),
            "chain": lambda: chain(feat, wclf, bclf, out_hw),
            "plain": lambda: clf_upsample_argmax_plain(feat, wclf, bclf,
                                                       out_hw)}
    ms = turns_ms(arms, ms_of)
    print(f"# device={device_name(dev)} b{b} {cin}ch {h}x{w} -> {out_hw} K={k}")
    print("fused vs plain twin: bit-identical True")
    print(f"mask agreement vs chain: {agree!r}")
    for name, t in ms.items():
        print(f"{name}: {fmt_ms(t)}")
    return dict(device=device_name(dev), mask_agreement_vs_chain=agree, ms=ms)


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0], argv,
                      hwk=dict(nargs="*", type=int, default=[256, 512, 19]))
    h, w, k = args.hwk
    run(args.device, h=h, w=w, k=k)


if __name__ == "__main__":
    main()
