"""A/B of the classifier-fused tail against the port's chain of the
classifier kernel and the production tail (counterpart:
scripts/exp_tail_flat.py).

The chain writes the [B, K, h, w] bf16 logits to device memory and reads
them back; the fused tail (``kernels.tail_flat.clf_upsample_argmax``)
applies the [K, C] classifier to the decoder's feature map itself. Arms,
on the same seeded features (default b8, 48 channels, 256 x 512 ->
1024 x 2048, K = 19; the script's seeds), timed in turns:

* ``fused``: ``clf_upsample_argmax``;
* ``v1``: its first-form kernel (``clf_upsample_argmax_v1``), kept for
  this A/B;
* ``chain``: ``conv_chw`` (k = 1, the classifier) then ``upsample_argmax``;
* ``plain``: the fused tail's plain PyTorch twin;
* ``library``: the same function in PyTorch calls (the 1x1 ``F.conv2d``,
  ``F.interpolate`` in f32, ``argmax``), which round elsewhere.

The fused kernel (and its v1 form) must equal its twin bit for bit. Its
mask agrees with the chain's on a share just below 1, by construction: the
experiment rounds the W-pass weights to bf16, the production tail keeps
them in f32. Each case prints its bound (``tail_bound``: the larger of its
bytes over the HBM rate and its operations, the classifier's dot products
at the bf16 peak and the H and W passes at the f32 peak), its f32 issue
floor (``tail_floor``: the same work as f32 instructions on the CUDA
cores, where the twin's channel-order sum keeps the classifier) and the
classifier's recomputed share at the plan (``clf_tail_recompute``, for
one block an SM on 132 SMs).

    python3 -m segtpu_torch.scripts.exp_tail_flat [h w K]
    python3 -m segtpu_torch.scripts.exp_tail_flat --forms   # TAIL_FORMS
    python3 -m segtpu_torch.scripts.exp_tail_flat --tiles   # CLF_TILES
"""

from __future__ import annotations

import numpy as np
import torch

from segtpu_torch.kernels.chw_ops import conv_chw
from segtpu_torch.kernels import tail_flat
from segtpu_torch.kernels.tail_flat import (CLF_TILES, clf_tail_plan,
                                            clf_tail_recompute,
                                            clf_upsample_argmax,
                                            clf_upsample_argmax_plain,
                                            clf_upsample_argmax_v1, v1_smem)
from segtpu_torch.kernels.upsample_argmax import upsample_argmax
from segtpu_torch.scripts import (F32_FMA_MEASURED_FLOP_PER_S,
                                  F32_ISSUE_PER_S, bits_equal, bound_ms,
                                  device_arg, device_name, fmt_ms, timer,
                                  turns_ms)
from segtpu_torch.utils.helpers import resolve_device

NOMINAL_GRID = 132            # blocks: one a SM of an H100 at the plan
# (B, C, h, w, K, Ho, Wo): the forms the script's case does not reach:
# K = 1, 3, 21 and 150, C = 8 and 64, ragged outputs, a ratio that is not
# an integer, w = 8, one image
TAIL_FORMS = ((8, 48, 256, 512, 1, 1024, 2048),
              (8, 48, 256, 512, 3, 1024, 2048),
              (8, 48, 256, 512, 21, 1024, 2048),
              (8, 48, 256, 512, 150, 1024, 2048),
              (8, 8, 256, 512, 19, 1024, 2048),
              (8, 64, 256, 512, 19, 1024, 2048),
              (8, 48, 256, 512, 19, 1000, 2000),
              (8, 48, 256, 512, 19, 720, 1280),
              (8, 48, 256, 8, 19, 1024, 32),
              (1, 48, 256, 512, 19, 1024, 2048))


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


def library(feat, wclf, bclf, out_hw):
    """The function as PyTorch library calls: the 1x1 ``F.conv2d`` in
    bf16, ``F.interpolate`` in f32 (align_corners), ``argmax``."""
    import torch.nn.functional as F
    logits = F.conv2d(feat, wclf[:, :, None, None],
                      bclf.to(torch.bfloat16)).float()
    return F.interpolate(logits, size=tuple(out_hw), mode="bilinear",
                         align_corners=True).argmax(1)


def tail_work(b, cin, h, w, k, ho, wo):
    """(bytes, dot, f32) of one call: the features and the classifier
    read once and the mask written once; the classifier's multiply-adds
    as dot products (two operations each); the bias add a logit, the H
    pass once per (class, output row, input column: 2 multiplies, 1 add)
    and the W pass and compare per (output pixel, class: 2 multiplies,
    1 add, 1 compare) as f32 operations."""
    nbytes = b * cin * h * w * 2 + k * cin * 2 + k * 4 + b * ho * wo
    return (nbytes, 2 * b * k * cin * h * w,
            b * k * (h * w + ho * (3 * w + 4 * wo)))


def tail_bound(b, cin, h, w, k, ho, wo):
    """(ms, "bytes" or "operations"): the least time of one call on the
    card, ``tail_work`` at the data sheet's rates (``bound_ms``)."""
    return bound_ms(*tail_work(b, cin, h, w, k, ho, wo))


def tail_floor(b, cin, h, w, k, ho, wo) -> dict:
    """{"f32 issue": ms, "f32 issue measured": ms}: the floor of a design
    on the CUDA cores, which the twin's channel-order sum forces: each of
    the classifier's multiply-adds one fmaf and every other operation of
    ``tail_work`` one f32 instruction, at the data sheet's issue rate and,
    as a note, at half the measured fmaf rate."""
    _, dot, f32 = tail_work(b, cin, h, w, k, ho, wo)
    ops = dot // 2 + f32
    return {"f32 issue": ops / F32_ISSUE_PER_S * 1e3,
            "f32 issue measured": ops / (F32_FMA_MEASURED_FLOP_PER_S / 2)
            * 1e3}


def bench(dev, b, cin, h, w, k, out_hw, label="tail"):
    """One case: the checks, then every arm timed in turns."""
    ms_of = timer(dev)
    feat, wclf, bclf = tail_inputs(b, cin, h, w, k, dev)
    ho, wo = out_hw
    what = f"{label} b{b} {cin}ch {h}x{w} -> {ho}x{wo} K={k}"
    got = clf_upsample_argmax(feat, wclf, bclf, out_hw)
    want = clf_upsample_argmax_plain(feat, wclf, bclf, out_hw)
    if not bits_equal(got, want):
        raise AssertionError(f"{what}: clf_upsample_argmax differs from its "
                             f"plain twin")
    # the v1 kernel stages a tile's whole feature band: at K = 150 it
    # does not fit shared memory, and its arm is not run
    v1 = v1_smem(cin, k, h, w, ho, wo) <= 227 * 1024
    if dev.type == "cuda" and v1 and not bits_equal(
            clf_upsample_argmax_v1(feat, wclf, bclf, out_hw), want):
        raise AssertionError(f"{what}: the v1 kernel differs from the twin")
    agree = (got == chain(feat, wclf, bclf, out_hw)).float().mean().item()
    lib_agree = (library(feat, wclf, bclf, out_hw).to(torch.uint8)
                 == got).float().mean().item()
    del got, want
    arms = {"fused": lambda: clf_upsample_argmax(feat, wclf, bclf, out_hw),
            "v1": lambda: clf_upsample_argmax_v1(feat, wclf, bclf, out_hw),
            "chain": lambda: chain(feat, wclf, bclf, out_hw),
            "plain": lambda: clf_upsample_argmax_plain(feat, wclf, bclf,
                                                       out_hw),
            "library": lambda: library(feat, wclf, bclf, out_hw)}
    if not v1:
        del arms["v1"]
    ms = {"v1": None, **turns_ms(arms, ms_of)}
    bound, by = tail_bound(b, cin, h, w, k, ho, wo)
    floor = tail_floor(b, cin, h, w, k, ho, wo)
    plan = clf_tail_plan(cin, k, h, w, ho, wo)
    share = clf_tail_recompute(plan, b, h, w, ho, wo, NOMINAL_GRID)
    print(f"{what}: fused {fmt_ms(ms['fused'])} (v1 kernel "
          + (fmt_ms(ms['v1']) if v1 else "does not fit shared memory")
          + f"), chain {fmt_ms(ms['chain'])}, plain "
          f"{fmt_ms(ms['plain'])}, library {fmt_ms(ms['library'])}; bound "
          f"{bound:.4f} ms ({by}); f32 issue floor "
          f"{floor['f32 issue']:.4f} ms (at the measured fmaf rate "
          f"{floor['f32 issue measured']:.4f}); plan {tuple(plan)}, classifier "
          f"recompute {share:.3f}x; bit-identical True; mask agreement vs "
          f"chain {agree!r}, vs library {lib_agree!r}")
    return dict(case=what, shape=(b, cin, h, w, k, ho, wo), ms=ms,
                bound_ms=bound, bound_by=by, issue_ms=floor["f32 issue"],
                issue_measured_ms=floor["f32 issue measured"], plan=tuple(plan),
                recompute=share, mask_agreement_vs_chain=agree,
                mask_agreement_vs_library=lib_agree)


def run(device="cuda", b=8, cin=48, h=256, w=512, k=19):
    """The script's case (out_hw = 4x the feature map)."""
    dev = resolve_device(device)
    print(f"# device={device_name(dev)}")
    r = bench(dev, b, cin, h, w, k, (4 * h, 4 * w))
    return dict(device=device_name(dev), ms=r["ms"], case=r,
                mask_agreement_vs_chain=r["mask_agreement_vs_chain"])


def run_forms(device="cuda", forms=TAIL_FORMS):
    """Every form of ``forms``; returns {"device": name, "forms": [...]}."""
    dev = resolve_device(device)
    print(f"# device={device_name(dev)}")
    return dict(device=device_name(dev), forms=[
        bench(dev, b, cin, h, w, k, (ho, wo), label="tail form")
        for b, cin, h, w, k, ho, wo in forms])


def run_tiles(device="cuda", b=8, cin=48, h=256, w=512, k=19,
              tiles=CLF_TILES):
    """The fused kernel at every tile of ``tiles`` (the plan's is
    CLF_TILES' first that fits), bit for bit against the twin, timed in
    turns at the script's case; returns {tile: ms}."""
    dev = resolve_device(device)
    feat, wclf, bclf = tail_inputs(b, cin, h, w, k, dev)
    out_hw = (4 * h, 4 * w)
    want = clf_upsample_argmax_plain(feat, wclf, bclf, out_hw)
    arms = {}
    for tile in tiles:
        def arm(tile=tile):
            if dev.type != "cuda":
                return clf_upsample_argmax_plain(feat, wclf, bclf, out_hw)
            return tail_flat._clf_launch(feat, wclf, bclf, out_hw, tile)
        if not bits_equal(arm(), want):
            raise AssertionError(f"fused tail at tile {tile} differs from "
                                 f"its twin")
        arms[tile] = arm
    ms = turns_ms(arms, timer(dev))
    for tile, t in ms.items():
        plan = clf_tail_plan(cin, k, h, w, *out_hw, tile)
        print(f"fused tail b{b} {cin}ch {h}x{w} K={k} tile {tile}: "
              f"{fmt_ms(t)}, plan {tuple(plan)}")
    return ms


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0], argv,
                      hwk=dict(nargs="*", type=int, default=[256, 512, 19]),
                      **{"--forms": dict(action="store_true"),
                         "--tiles": dict(action="store_true")})
    if args.forms:
        run_forms(args.device)
        return
    if args.tiles:
        run_tiles(args.device)
        return
    h, w, k = args.hwk
    run(args.device, h=h, w=w, k=k)


if __name__ == "__main__":
    main()
