"""The card's achievable f32 rate, two ways (counterpart:
scripts/exp_vpu_floor.py). Every kernel of the port runs its arithmetic
as f32 on the CUDA cores, and their bounds use the data sheet's
67 TFLOP/s; this measures what the card reaches:

  1. peak: independent fused multiply-add chains, one element a thread
     (``kernels.vpu_floor.fma_peak``), at (n_fma, n_acc) = (256, 8),
     (256, 4), (64, 4) on f32 [64, 48, 8192], and at (1024, 8), whose
     arithmetic hides the loads and stores.
  2. taploop: the production depthwise tap loop (dx-major windows, a
     column mask per dx; ``kernels.vpu_floor.dw_tap_sum``) at the shapes
     the decoder cells and encoder blocks run, 16 tiles each.
  3. roll: the experiment's second form of the tap loop, whose dx shift
     is a TPU lane rotate. On the card a shift is an address offset, so
     roll runs the tap loop's kernel: at the one roll shape the tap cases
     lack, the others being the tap rows.

Each case runs the kernel and its plain twin on the same seeded inputs,
checks them (rel 1e-5 for the peak, bit for bit for the tap loop) and
times both with CUDA events; the peak is timed over a sustained half
second while nvidia-smi samples the SM clock and the power draw. Prints
TFLOP/s and Gtap*ch*px/s.

    python3 -m segtpu_torch.scripts.exp_vpu_floor [all|peak|tap|roll]
"""

from __future__ import annotations

import torch

from segtpu_torch.kernels.vpu_floor import (dw_tap_sum, dw_tap_sum_plain,
                                            fma_peak, fma_peak_plain,
                                            tap_halo, taps)
from segtpu_torch.scripts import (bits_equal, cuda_ms, device_arg,
                                  device_name, fmt_ms, timer,
                                  with_clock_samples)
from segtpu_torch.utils.helpers import resolve_device

PEAK_SHAPE = (64, 48, 8192)              # grid, C, tile
# the experiment's three cases, then a longer chain that hides the
# loads and stores of the others behind more arithmetic
PEAK_CASES = ((256, 8), (256, 4), (64, 4), (1024, 8))
# (C, k, dilation, w, tile_rows): window-count scaling at k = 3/5/7, the
# decoder cells' dilated shapes, the encoder's mid shapes
TAP_CASES = ((48, 3, 1, 512, 64), (48, 5, 1, 512, 64), (48, 7, 1, 512, 64),
             (48, 3, 3, 512, 64), (48, 5, 6, 512, 64), (144, 3, 1, 512, 32),
             (96, 3, 1, 512, 32), (32, 3, 1, 1024, 32))
# the experiment's roll cases run the tap loop's kernel; of its shapes
# only this one is not among TAP_CASES, which give the others
ROLL_CASES = ((144, 3, 1, 512, 64),)
TAP_GRID = 16
PEAK_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def tap_bound_ms(c, k, dil, w, tile_rows, grid=TAP_GRID) -> float:
    """Least time of one tap-loop call on the card: its bytes (the bf16
    tiles with their halos and the f32 weights read once, the f32 output
    written once) over the HBM rate; its f32 work is below that."""
    x = grid * c * (tile_rows * w + 2 * tap_halo(k, dil, w)) * 2
    return (x + k * k * c * 4 + grid * c * tile_rows * w * 4) \
        / HBM_BYTES_PER_S * 1e3


def peak_flops(numel: int, n_fma: int, n_acc: int) -> float:
    """f32 operations of one fma_peak call: n_acc multiplies, the chains'
    fused multiply-adds at two each, n_acc - 1 adds, per element."""
    return float(numel) * (n_acc + 2 * (n_fma // n_acc) * n_acc + n_acc - 1)


def rel_err(got, want) -> float:
    """Largest |got - want| / |want| (an exact zero of both counts 0)."""
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def tap_inputs(c, k, dil, w, tile_rows, grid, dev, seed=0):
    """Seeded halo'd tile x bf16 [grid, C, halo + P + halo] and f32
    weights [k*k, C, 1]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    total = tile_rows * w + 2 * tap_halo(k, dil, w)
    x = torch.randn((grid, c, total), generator=g, device=dev)
    wt = torch.randn((k * k, c, 1), generator=g, device=dev)
    return x.to(torch.bfloat16), wt


def bench_peak(dev, n_fma, n_acc, shape=PEAK_SHAPE, seed=0):
    ms_of = timer(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    got = fma_peak(x, n_fma=n_fma, n_acc=n_acc)
    want = fma_peak_plain(x, n_fma=n_fma, n_acc=n_acc)
    rel = rel_err(got, want)
    if not rel <= PEAK_RTOL:
        raise AssertionError(f"fma_peak n_fma={n_fma} n_acc={n_acc}: relative "
                             f"error {rel} > {PEAK_RTOL}")
    # a sustained half second under clock sampling: the rate the card
    # holds, beside the clock it holds it at
    ms, clocks = (None, []) if dev.type != "cuda" else with_clock_samples(
        lambda: cuda_ms(lambda: fma_peak(x, n_fma=n_fma, n_acc=n_acc),
                        window_ms=500.0))
    plain_ms = ms_of(lambda: fma_peak_plain(x, n_fma=n_fma, n_acc=n_acc))
    flops = peak_flops(x.numel(), n_fma, n_acc)
    mhz = sorted(c for c, _ in clocks)
    r = dict(case=f"peak fma: C={shape[1]} tile={shape[2]} grid={shape[0]} "
             f"n_fma={n_fma} n_acc={n_acc}", ms=ms, plain_ms=plain_ms,
             max_rel_err=rel, flops=flops,
             tflops=None if ms is None else flops / ms / 1e9,
             sm_mhz_median=mhz[len(mhz) // 2] if mhz else None,
             sm_mhz_range=(mhz[0], mhz[-1]) if mhz else None,
             power_w_max=max(w for _, w in clocks) if clocks else None)
    print(f"{r['case']}: {fmt_ms(ms)}"
          + ("" if ms is None else f" -> {r['tflops']:.2f} TFLOP/s f32")
          + f"; plain {fmt_ms(plain_ms)}; max rel err {rel:.3g}"
          + ("" if not mhz else f"; SM clock median {r['sm_mhz_median']:.0f} "
             f"MHz (range {mhz[0]:.0f}-{mhz[-1]:.0f}), power max "
             f"{r['power_w_max']:.1f} W over {len(mhz)} samples"))
    return r


def bench_taploop(dev, c, k, dil, w=512, tile_rows=64, grid=TAP_GRID, seed=0,
                  label="taploop"):
    ms_of = timer(dev)
    x, wt = tap_inputs(c, k, dil, w, tile_rows, grid, dev, seed)
    kw = dict(k=k, dilation=dil, w=w)
    got = dw_tap_sum(x, wt, **kw)
    same = bits_equal(got, dw_tap_sum_plain(x, wt, **kw))
    if not same:
        raise AssertionError(f"dw_tap_sum C={c} k={k} dil={dil}: kernel and "
                             f"plain twin differ")
    ms = ms_of(lambda: dw_tap_sum(x, wt, **kw))
    plain_ms = ms_of(lambda: dw_tap_sum_plain(x, wt, **kw))
    n_taps = len(taps(k, dil, 10**6, w))
    tap_px = float(n_taps) * got.numel()
    r = dict(case=f"{label}: C={c} k={k} dil={dil} taps={n_taps} "
             f"tile={tile_rows}x{w} grid={grid}", ms=ms, plain_ms=plain_ms,
             bit_identical=same, flops=2 * tap_px,
             tflops=None if ms is None else 2 * tap_px / ms / 1e9,
             gtap_px_s=None if ms is None else tap_px / ms / 1e6,
             bound_ms=tap_bound_ms(c, k, dil, w, tile_rows, grid))
    print(f"{r['case']}: {fmt_ms(ms)}"
          + ("" if ms is None else f" -> {r['tflops']:.2f} TFLOP/s f32 "
             f"({r['gtap_px_s']:.1f} Gtap-ch-px/s)")
          + f"; bound {r['bound_ms']:.4f} ms (bytes); plain {fmt_ms(plain_ms)}"
          f"; bit-identical {same}")
    return r


def run(device="cuda", which="all", peak_shape=PEAK_SHAPE,
        peak_cases=PEAK_CASES, tap_cases=TAP_CASES, roll_cases=ROLL_CASES,
        tap_grid=TAP_GRID):
    """Every case of ``which`` (all, peak, tap or roll); returns
    {"device": name, "peak": [...], "tap": [...], "roll": [...]}."""
    dev = resolve_device(device)
    print(f"# device={device_name(dev)}")
    out = {"device": device_name(dev), "peak": [], "tap": [], "roll": []}
    if which in ("all", "peak"):
        for n_fma, n_acc in peak_cases:
            out["peak"].append(bench_peak(dev, n_fma, n_acc, peak_shape))
    if which in ("all", "tap"):
        for c, k, dil, w, rows in tap_cases:
            out["tap"].append(bench_taploop(dev, c, k, dil, w, rows, tap_grid))
    if which in ("all", "roll"):
        print("# roll: the tap loop's kernel; the tap rows above give the "
              "roll shapes they share")
        for c, k, dil, w, rows in roll_cases:
            out["roll"].append(bench_taploop(
                dev, c, k, dil, w, rows, tap_grid,
                label="taploop-roll (same kernel as taploop)"))
    return out


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0], argv, which=dict(
        nargs="?", default="all", choices=("all", "peak", "tap", "roll")))
    run(args.device, args.which)


if __name__ == "__main__":
    main()
