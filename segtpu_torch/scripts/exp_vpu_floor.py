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
  4. forms (not the experiment's; not in ``all``): the tap loop at the
     forms its cases do not reach (TAP_FORMS).

Each case runs the kernel and its plain twin on the same seeded inputs and
checks them (rel 1e-5 for the peak; bit for bit for the tap loop, whose
v1 kernel, kept for the A/B, must give the same bits, and whose grouped
``F.conv2d`` yardstick must agree to LIB_RTOL); the peak is timed over a
sustained half second while nvidia-smi samples the SM clock and the power
draw, a tap case's kernel, v1 kernel, twin and convolution in turns
with CUDA events, beside its bound: the larger of its bytes over the HBM
rate and the f32 instructions it needs at the data sheet's issue rate
(the loop fuses nothing; ``tap_ops``), with which one sets it, and the
instructions at half the measured fmaf rate as a note. Prints TFLOP/s
and Gtap*ch*px/s.

    python3 -m segtpu_torch.scripts.exp_vpu_floor [all|peak|tap|roll|forms]
"""

from __future__ import annotations

import torch

from segtpu_torch.kernels.vpu_floor import (dw_tap_sum, dw_tap_sum_plain,
                                            dw_tap_sum_v1, fma_peak,
                                            fma_peak_plain, tap_halo, taps)
from segtpu_torch.scripts import (F32_FMA_MEASURED_FLOP_PER_S,
                                  F32_ISSUE_PER_S, HBM_BYTES_PER_S,
                                  bits_equal, cuda_ms, device_arg,
                                  device_name, fmt_ms, timer, turns_ms,
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
# (C, k, dilation, w, tile_rows, sign): forms the cases do not reach: one
# channel, k at run time (9) and the largest k (15), rows that end inside
# a strip, w = 8 (the taps' wrap reaches across the whole row), and the
# sign form (tap_inputs(sign=True): the outputs of column 0 are the
# sign of a zero, set by the wrapped read)
TAP_FORMS = ((1, 3, 1, 512, 64, False), (48, 9, 1, 512, 64, False),
             (48, 15, 1, 512, 64, False), (48, 3, 1, 512, 61, False),
             (48, 15, 1, 8, 64, False), (48, 3, 1, 512, 64, True))
TAP_GRID = 16
PEAK_RTOL = 1e-5
LIB_RTOL = 1e-4     # the grouped convolution sums in its own order


def tap_ops(c, k, dil, w, tile_rows, grid=TAP_GRID) -> int:
    """f32 instructions one tap-loop call needs, none of which may fuse:
    per output a product a tap, the sums within each dx and across the
    dxs (2 taps - 1 in all), and a mask multiply by 0 only where a tap
    leaves its row, at |dx| columns of each row for each dx beside 0."""
    tl = taps(k, dil, 10**6, w)
    edge = sum(min(abs(dx), w) for dx in {t[2] for t in tl})
    return grid * c * tile_rows * (w * (2 * len(tl) - 1) + edge)


def tap_floors(c, k, dil, w, tile_rows, grid=TAP_GRID) -> dict:
    """{"bytes": ms, "f32 issue": ms, "f32 issue measured": ms} of one
    tap-loop call: its bytes (the bf16 tiles with their halos and the f32
    weights read once, the f32 output written once) over the HBM rate,
    and its f32 instructions (``tap_ops``) at the data sheet's issue rate
    and, as a note, at half the measured fmaf rate."""
    x = grid * c * (tile_rows * w + 2 * tap_halo(k, dil, w)) * 2
    nbytes = x + k * k * c * 4 + grid * c * tile_rows * w * 4
    ops = tap_ops(c, k, dil, w, tile_rows, grid)
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "f32 issue": ops / F32_ISSUE_PER_S * 1e3,
            "f32 issue measured": ops / (F32_FMA_MEASURED_FLOP_PER_S / 2)
            * 1e3}


def tap_bound(c, k, dil, w, tile_rows, grid=TAP_GRID):
    """(ms, "bytes" or "f32 issue"): the least time of one tap-loop call,
    the larger of its bytes and its f32 instructions at the data sheet's
    issue rate (``tap_floors``). Bytes set it up to k = 5, the
    instructions at k = 7 and above."""
    ms = tap_floors(c, k, dil, w, tile_rows, grid)
    by = max(("bytes", "f32 issue"), key=ms.get)
    return ms[by], by


def tap_bound_ms(c, k, dil, w, tile_rows, grid=TAP_GRID) -> float:
    """Least time of one tap-loop call on the card (``tap_bound``)."""
    return tap_bound(c, k, dil, w, tile_rows, grid)[0]


def peak_flops(numel: int, n_fma: int, n_acc: int) -> float:
    """f32 operations of one fma_peak call: n_acc multiplies, the chains'
    fused multiply-adds at two each, n_acc - 1 adds, per element."""
    return float(numel) * (n_acc + 2 * (n_fma // n_acc) * n_acc + n_acc - 1)


def rel_err(got, want) -> float:
    """Largest |got - want| / |want| (an exact zero of both counts 0)."""
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def tap_inputs(c, k, dil, w, tile_rows, grid, dev, seed=0, sign=False):
    """Seeded halo'd tile x bf16 [grid, C, halo + P + halo] and f32
    weights [k*k, C, 1]. ``sign``: x zero but in each row's last column
    and the weights negative, so an output of column 0 is a zero whose
    sign is that of its wrapped partials (the previous row's last pixels
    times negative weights, masked by 0), every other partial there -0.0:
    a kernel that skips or zero-fills the wrapped read gives -0.0 where
    the twin gives +0.0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    total = tile_rows * w + 2 * tap_halo(k, dil, w)
    x = torch.randn((grid, c, total), generator=g, device=dev)
    wt = torch.randn((k * k, c, 1), generator=g, device=dev)
    if sign:
        last = (torch.arange(total, device=dev) % w) == w - 1
        x = torch.where(last, x, torch.zeros((), device=dev))
        wt = -wt.abs() - 0.125
    return x.to(torch.bfloat16), wt


def tap_library(x, wt, k, dil, w):
    """The tap loop as one grouped ``F.conv2d`` of the f32 cast (the
    default halo: whole rows), its horizontal zero padding in place of the
    mask, summing in its own order. Returns (the call, a function taking
    its output to the tile's [G, C, P]: output rows 1 .. rows)."""
    import torch.nn.functional as F
    g, c, total = x.shape
    xf = x.float().reshape(g, c, total // w, w)
    wconv = wt.reshape(k, k, c).permute(2, 0, 1)[:, None].contiguous()

    def call():
        return F.conv2d(xf, wconv, padding=(0, dil * (k // 2)), dilation=dil,
                        groups=c)

    return call, lambda out: out[:, :, 1:-1].reshape(g, c, -1)


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
                  label="taploop", sign=False):
    """One tap case: the kernel bit for bit against its twin (and, on the
    card, the v1 kernel too), the grouped convolution within LIB_RTOL;
    then the kernel, the v1 kernel, the twin and the convolution timed in
    turns, beside the case's bound."""
    ms_of = timer(dev)
    x, wt = tap_inputs(c, k, dil, w, tile_rows, grid, dev, seed, sign)
    kw = dict(k=k, dilation=dil, w=w)
    got = dw_tap_sum(x, wt, **kw)
    want = dw_tap_sum_plain(x, wt, **kw)
    same = bits_equal(got, want)
    what = f"dw_tap_sum C={c} k={k} dil={dil} w={w} rows={tile_rows}" \
        + (" sign" if sign else "")
    if not same:
        raise AssertionError(f"{what}: kernel and plain twin differ")
    if dev.type == "cuda" and not bits_equal(dw_tap_sum_v1(x, wt, **kw), want):
        raise AssertionError(f"{what}: the v1 kernel and the twin differ")
    lib, lib_out = tap_library(x, wt, k, dil, w)
    lib_err = (lib_out(lib()) - want).abs().max().item()
    if not lib_err <= LIB_RTOL * want.abs().max().item():
        raise AssertionError(f"{what}: the grouped convolution differs by "
                             f"{lib_err}")
    del got
    ms = turns_ms({"ms": lambda: dw_tap_sum(x, wt, **kw),
                   "old_ms": lambda: dw_tap_sum_v1(x, wt, **kw),
                   "plain_ms": lambda: dw_tap_sum_plain(x, wt, **kw),
                   "library_ms": lib}, ms_of)
    n_taps = len(taps(k, dil, 10**6, w))
    tap_px = float(n_taps) * want.numel()
    bound, by = tap_bound(c, k, dil, w, tile_rows, grid)
    t = ms["ms"]
    r = dict(case=f"{label}: C={c} k={k} dil={dil} taps={n_taps} "
             f"tile={tile_rows}x{w} grid={grid}" + (" sign" if sign else ""),
             shape=(c, k, dil, w, tile_rows, grid), sign=sign,
             bit_identical=same, max_lib_err=lib_err, **ms,
             flops=2 * tap_px,
             tflops=None if t is None else 2 * tap_px / t / 1e9,
             gtap_px_s=None if t is None else tap_px / t / 1e6,
             bound_ms=bound, bound_by=by)
    floors = tap_floors(c, k, dil, w, tile_rows, grid)
    r["bytes_ms"], r["issue_ms"] = floors["bytes"], floors["f32 issue"]
    r["issue_measured_ms"] = floors["f32 issue measured"]
    print(f"{r['case']}: {fmt_ms(t)} (v1 kernel {fmt_ms(ms['old_ms'])})"
          + ("" if t is None else f" -> {r['gtap_px_s']:.1f} Gtap-ch-px/s, "
             f"{t / bound:.2f}x the bound")
          + f"; bound {bound:.4f} ms ({by}; bytes {r['bytes_ms']:.4f}, f32 "
          f"issue {r['issue_ms']:.4f}, at the measured fmaf rate "
          f"{r['issue_measured_ms']:.4f}); plain {fmt_ms(ms['plain_ms'])}; "
          f"grouped F.conv2d {fmt_ms(ms['library_ms'])}; bit-identical {same}")
    return r


def run(device="cuda", which="all", peak_shape=PEAK_SHAPE,
        peak_cases=PEAK_CASES, tap_cases=TAP_CASES, roll_cases=ROLL_CASES,
        tap_grid=TAP_GRID, tap_forms=TAP_FORMS):
    """Every case of ``which``: all (the experiment's peak, tap and roll
    cases), peak, tap, roll, or forms (TAP_FORMS, which the experiment
    lacks); returns {"device": name, "peak": [...], "tap": [...], "roll":
    [...], "forms": [...]}."""
    dev = resolve_device(device)
    print(f"# device={device_name(dev)}")
    out = {"device": device_name(dev), "peak": [], "tap": [], "roll": [],
           "forms": []}
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
    if which == "forms":
        for c, k, dil, w, rows, sign in tap_forms:
            out["forms"].append(bench_taploop(dev, c, k, dil, w, rows,
                                              tap_grid, label="tap form",
                                              sign=sign))
    return out


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0], argv, which=dict(
        nargs="?", default="all",
        choices=("all", "peak", "tap", "roll", "forms")))
    run(args.device, args.which)


if __name__ == "__main__":
    main()
