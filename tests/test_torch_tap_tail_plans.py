"""The plans of the depthwise tap kernel (kernels/vpu_floor.py tap_plan)
and of the classifier-fused tail (kernels/tail_flat.py clf_tail_plan),
checked on the CPU, where the kernels cannot run:

* every plan of the scripts' cases and the chip's forms fits shared
  memory, its layout is the one the C entry checks, and its items cover
  every output exactly once;
* a numpy float32 walk of each kernel's work, item by item as its
  persistent blocks take them, from the staged span (tap) or the staged
  feature rows and the logit ring (tail) only, every product and sum
  rounded once, gives the plain twins' bits at small shapes that reach
  each trap: the wrapped read and the -0.0 it leaves, dropped taps, the
  compiled and the run-time forms, ragged strips and edges, chunked
  classes, single-entry and downsampling taps, blocks starting mid-column;
* a stood-in C entry records the ints each wrapper hands the library.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from segtpu_torch.kernels import tail_flat as tf
from segtpu_torch.kernels import vpu_floor as vf
from segtpu_torch.kernels.tail_flat import (clf_new_rows, clf_tail_plan,
                                            clf_tail_recompute, clf_tail_smem,
                                            clf_tail_walk,
                                            clf_upsample_argmax_plain)
from segtpu_torch.kernels.upsample_argmax import interp_taps
from segtpu_torch.kernels.vpu_floor import (TAP_COMPILED, dw_tap_sum_plain,
                                            tap_halo, tap_margin, tap_plan,
                                            tap_smem, taps)
from segtpu_torch.scripts import bits_equal, exp_tail_flat, exp_vpu_floor

F32 = np.float32
SMEM = 227 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs several
    workers, each would otherwise spawn a pool); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16r(v):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(v, F32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(
        0xFFFF0000)
    return u.view(F32)


# ------------------------------------------------------------ the tap plans

def _tap_geometry(case):
    c, k, dil, w, rows = case[:5]
    return c, k, dil, w, rows, rows * w, tap_halo(k, dil, w)


def _check_tap_plan(case, grid=16):
    c, k, dil, w, rows, p, halo = _tap_geometry(case)
    plan = tap_plan(c, k, dil, w, rows)
    assert plan.smem == tap_smem(plan.s, plan.lo, k) <= SMEM
    assert plan.lo == plan.hi == tap_margin(k, dil, w)
    assert plan.s % 8 == 0 and plan.nt % 32 == 0 and plan.nt <= 256
    reach = max(abs(dy) for _, dy, _ in taps(k, dil, 10**6, w)) * w + max(
        abs(dx) for _, _, dx in taps(k, dil, 10**6, w))
    assert plan.lo >= reach + 8
    # the strips of a plane and their groups of 8 cover [0, P) once
    nstrip = -(-p // plan.s)
    hits = np.zeros(p + 8, int)
    for s0 in range(0, nstrip * plan.s, plan.s):
        ngrp = -(-min(plan.s, p - s0) // 8)
        for p0 in range(s0, s0 + 8 * ngrp, 8):
            hits[p0:p0 + 8] += 1
    assert (hits[:p] == 1).all() and (hits[p:] <= 1).all()
    # the default halo stages by 16-byte copies, the output by float4
    assert vf.tap_args(plan, p, halo, 0, 0)[-2:] == (1, 1)
    return plan


@pytest.mark.parametrize("group", ["cases", "forms"])
def test_tap_plans_fit_and_cover(group):
    """Every tap case and roll case of the script, every chip form."""
    cases = (exp_vpu_floor.TAP_CASES + exp_vpu_floor.ROLL_CASES
             if group == "cases" else exp_vpu_floor.TAP_FORMS)
    plans = [_check_tap_plan(case) for case in cases]
    if group == "cases":     # all at the vocabulary's compiled pairs
        assert all(p.kt and p.dt for p in plans)
    else:                    # k = 9 and 15 take the run-time form
        assert [p.kt for p in plans] == [3, 0, 0, 3, 0, 3]


def test_tap_plan_compiles_only_where_the_window_fits():
    assert tap_plan(48, 3, 1, 512, 64)[4:6] == (3, 1)
    assert tap_plan(48, 5, 6, 512, 64)[4:6] == (5, 6)
    assert tap_plan(48, 5, 2, 512, 64)[4:6] == (0, 0)      # dilation 2
    assert tap_plan(48, 3, 1, 12, 64)[4:6] == (0, 0)       # w % 8
    assert tap_plan(48, 5, 6, 8, 64)[4:6] == (0, 0)        # dx 12 >= w
    assert all(tap_plan(4, k, d, 64, 8).kt == k for k, d in TAP_COMPILED)
    with pytest.raises(ValueError):
        tap_plan(4, 17, 1, 64, 8)


def test_tap_bound_is_the_larger_floor():
    """Bytes set k = 3's bound, the f32 instructions k = 7's: 2 taps - 1
    an output, and a mask multiply at |dx| columns of a row for each dx
    beside 0, at the data sheet's issue rate (half its f32 FLOP rate)."""
    b3, by3 = exp_vpu_floor.tap_bound(48, 3, 1, 512, 64)
    b7, by7 = exp_vpu_floor.tap_bound(48, 7, 1, 512, 64)
    assert by3 == "bytes" and by7 == "f32 issue"
    assert b3 == pytest.approx(0.0460, abs=1e-4)
    assert b7 == pytest.approx(16 * 48 * 64 * (512 * (2 * 49 - 1) + 12)
                               / (67e12 / 2) * 1e3, rel=1e-12)
    assert b7 == pytest.approx(0.0729, abs=1e-4)
    # w = 8, k = 15: every dx leaves the row at |dx| of its 8 columns
    assert exp_vpu_floor.tap_ops(48, 15, 1, 8, 64) == 16 * 48 * 64 * (
        8 * (2 * 225 - 1) + 2 * sum(range(1, 8)))


def test_tail_bound_and_floor():
    """The fused tail's bound takes the classifier's products at the bf16
    peak (bytes set it at the script's sizes); its CUDA-core floor counts
    each of them as one fmaf beside the H and W passes' instructions."""
    case = (8, 48, 256, 512, 19, 1024, 2048)
    nbytes, dot, f32 = exp_tail_flat.tail_work(*case)
    assert dot == 2 * 8 * 19 * 48 * 256 * 512
    assert exp_tail_flat.tail_bound(*case) == (
        pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12), "bytes")
    floor = exp_tail_flat.tail_floor(*case)
    assert floor["f32 issue"] == pytest.approx(
        (dot // 2 + f32) / (67e12 / 2) * 1e3, rel=1e-12)
    assert floor["f32 issue"] < floor["f32 issue measured"]


# ----------------------------------------------------------- the tap walk

def tap_walk(x, wt, k, dil, w, halo, plan, vin, grid):
    """The kernel's work in numpy float32 (csrc/vpu_floor.cu
    dw_tap_kernel): x f32 [G, C, T] (bf16 values), wt f32 [k*k, C]."""
    g_n, c_n, t_n = x.shape
    p_n = t_n - 2 * halo
    span = plan.lo + plan.s + plan.hi
    nstrip = -(-p_n // plan.s)
    out = np.zeros((g_n, c_n, p_n), F32)
    hits = np.zeros((g_n, c_n, p_n), int)
    half = k // 2
    for blk in range(grid):
        for item in range(blk, g_n * c_n * nstrip, grid):
            plane, strip = divmod(item, nstrip)
            g, c = divmod(plane, c_n)
            s0 = strip * plan.s
            q = halo + s0 - plan.lo + np.arange(span)
            if vin:      # whole 16-byte chunks, zero outside the plane
                assert q[0] % 8 == 0
                ok = np.repeat((q[::8] >= 0) & (q[::8] + 8 <= t_n), 8)
            else:
                ok = (q >= 0) & (q < t_n)
            buf = np.where(ok, x[g, c, np.clip(q, 0, t_n - 1)], 0).astype(F32)
            ws = wt[:, c]
            ngrp = -(-min(plan.s, p_n - s0) // 8)
            e = plan.lo + 8 * np.arange(ngrp)          # first output's element
            assert (e % 8 == 0).all()
            p0 = s0 + 8 * np.arange(ngrp)[:, None] + np.arange(8)
            col = p0 % w
            acc = None
            if plan.kt:
                kt, dt = plan.kt, plan.dt
                rx = dt * half
                a8 = -(-rx // 8) * 8
                nw = 8 + 2 * rx
                nv = (a8 - rx + nw + 7) // 8
                parts = [None] * kt
                for ky in range(kt):
                    base = e + dt * (ky - half) * w - a8
                    assert (base % 8 == 0).all() and base.min() >= 0
                    assert (base + 8 * nv).max() <= span
                    win = buf[base[:, None] + a8 - rx + np.arange(nw)]
                    for kx in range(kt):
                        term = F32(ws[ky * kt + kx]) \
                            * win[:, dt * kx:dt * kx + 8]
                        parts[kx] = term if ky == 0 else parts[kx] + term
                for kx in range(kt):        # masked partials times 0 only
                    dx, v = dt * (kx - half), parts[kx]
                    if dx:
                        v = np.where((col + dx >= 0) & (col + dx < w), v,
                                     v * F32(0))
                    acc = v if kx == 0 else acc + v
            else:
                for kx in range(k):
                    dx = dil * (kx - half)
                    if abs(dx) >= w:
                        continue
                    part = None
                    for ky in range(k):
                        t = e + dil * (ky - half) * w + dx
                        a = t & ~7          # two aligned vectors
                        assert a.min() >= 0 and (a + 16).max() <= span
                        term = F32(ws[ky * k + kx]) \
                            * buf[t[:, None] + np.arange(8)]
                        part = term if part is None else part + term
                    if dx:
                        part = np.where((col + dx >= 0) & (col + dx < w),
                                        part, part * F32(0))
                    acc = part if acc is None else acc + part
            keep = p0 < p_n
            assert (hits[g, c, p0[keep]] == 0).all()
            hits[g, c, p0[keep]] += 1
            out[g, c, p0[keep]] = acc[keep]
    assert (hits == 1).all()
    return out


# (G, C, k, dil, w, rows, strip, halo, sign): the compiled k = 3, 5, 7 at
# dilation 1 and the dilated 3 and 6; the run-time form at k = 9, at k = 15
# on w = 8 (every dx kept, the wrap across the whole row), at w = 12 (no
# 16-byte staging), at dilation 2, at a halo not a multiple of 8 and at
# k = 5, dilation 6 on w = 8 (dx 12 dropped); strips that end inside a row
# and a last strip cut short; the sign form
TAP_WALKS = [
    (2, 3, 3, 1, 16, 7, 32, None, False),
    (2, 3, 5, 1, 16, 6, 24, None, False),
    (1, 2, 7, 1, 16, 9, 40, None, False),
    (2, 2, 3, 3, 16, 8, 48, None, False),
    (1, 2, 5, 6, 16, 5, 32, None, False),
    (1, 2, 9, 1, 16, 5, 24, None, False),
    (2, 1, 15, 1, 8, 4, 16, None, False),
    (1, 2, 3, 1, 12, 5, 16, None, False),
    (2, 2, 5, 2, 16, 5, 40, None, False),
    (1, 2, 3, 1, 16, 4, 24, 21, False),
    (1, 2, 5, 6, 8, 6, 16, None, False),
    (2, 3, 3, 1, 16, 6, 32, None, True),
]


@pytest.mark.parametrize("case", TAP_WALKS)
def test_tap_walk_gives_the_twin_bits(case):
    g, c, k, dil, w, rows, strip, halo, sign = case
    halo = tap_halo(k, dil, w) if halo is None else halo
    x, wt = exp_vpu_floor.tap_inputs(c, k, dil, w, rows, g, "cpu",
                                     seed=rows + k, sign=sign)
    if halo != tap_halo(k, dil, w):
        x = x[:, :, tap_halo(k, dil, w) - halo:][:, :, :rows * w + 2 * halo]
    want = dw_tap_sum_plain(x, wt, k=k, dilation=dil, w=w, halo=halo)
    plan = tap_plan(c, k, dil, w, rows)._replace(s=strip)
    vin = vf.tap_args(plan, rows * w, halo, 0, 0)[-2]
    got = tap_walk(x.float().numpy(), wt[:, :, 0].numpy(), k, dil, w, halo,
                   plan, vin, grid=3)
    assert bits_equal(torch.from_numpy(got), want)
    if sign:       # column 0 holds zeros of both signs, set by the wraps
        z = want.reshape(g, c, rows, w)[:, :, 1:, 0]
        assert (z == 0).all() and 0 < torch.signbit(z).float().mean() < 1


# ---------------------------------------------------------- the tail plans

def _check_clf_plan(case, grid=132):
    b, c, h, w, k, ho, wo = case
    plan = clf_tail_plan(c, k, h, w, ho, wo)
    assert plan.smem == clf_tail_smem(plan.br, plan.nr, plan.nc, plan.kc, c,
                                      k) <= SMEM
    assert 1 <= plan.kc <= k and plan.nc % 8 == 0
    rows, _ = interp_taps(h, ho, True, ho, True)
    cols, _ = interp_taps(w, wo, True, wo, True)
    hits = np.zeros((b, ho, wo), np.int8)
    ring, prev = {}, None
    for blk, g, img, band, oy0, ox0 in clf_tail_walk(plan, b, ho, wo, grid):
        lo, hi = clf_new_rows(rows, blk != prev, band, oy0, plan.br, ho)
        prev = blk
        assert hi - lo + 1 <= plan.nr
        for r in range(lo, hi + 1):
            ring[blk, r % plan.nr] = (img, ox0, r)
        oy1, ox1 = min(oy0 + plan.br, ho), min(ox0 + plan.sw, wo)
        for r in np.unique(rows[:, oy0:oy1]):   # the H pass finds its rows
            assert ring[blk, r % plan.nr] == (img, ox0, r)
        c_lo = cols[0, ox0] // 8 * 8
        assert cols[:, ox0:ox1].max() - c_lo < plan.nc
        hits[img, oy0:oy1, ox0:ox1] += 1
    assert (hits == 1).all()
    return plan


@pytest.mark.parametrize("group", ["script", "forms"])
def test_clf_plans_fit_and_cover(group):
    """The script's case and every chip form: the plan fits, its bands
    and segments cover the mask once, each step's new rows fit the ring
    and the rows its H pass reads are there."""
    cases = ((8, 48, 256, 512, 19, 1024, 2048),) if group == "script" \
        else exp_tail_flat.TAIL_FORMS
    plans = [_check_clf_plan(case) for case in cases]
    if group == "script":
        assert tuple(plans[0][:5]) == (8, 512, 4, 144, 19)


def test_clf_recompute_share_at_the_script_sizes():
    """Columns: a 512-column segment stages 144 input columns for its 128;
    rows: each of the 132 blocks' first band again; far under the v1
    kernel's tiles' (a 16 x 256 tile's band of 6 x 72 for its 4 x 64)."""
    plan = clf_tail_plan(48, 19, 256, 512, 1024, 2048)
    share = clf_tail_recompute(plan, 8, 256, 512, 1024, 2048, 132)
    assert 1.125 < share < 1.2


# ---------------------------------------------------------- the tail walk

def clf_walk(feat, wclf, bclf, ho, wo, plan, grid):
    """The kernel's work in numpy float32 (csrc/tail_flat.cu
    clf_tail_kernel): feat f32 [B, C, h, w] and wclf [K, C] of bf16
    values, bclf f32 [K]."""
    b_n, c_n, h, w = feat.shape
    k_n = wclf.shape[0]
    rows, rw = interp_taps(h, ho, True, ho, True)
    cols, cw = interp_taps(w, wo, True, wo, True)
    out = np.full((b_n, ho, wo), -1, np.int16)
    ring = np.zeros((k_n, plan.nr, plan.nc), F32)
    ids, prev = [None] * plan.nr, None
    for blk, g, b, band, oy0, ox0 in clf_tail_walk(plan, b_n, ho, wo, grid):
        lo, hi = clf_new_rows(rows, blk != prev, band, oy0, plan.br, ho)
        prev = blk
        c_lo = int(cols[0, ox0]) // 8 * 8
        cnt = hi - lo + 1
        fs = np.zeros((c_n, max(cnt, 0), plan.nc), F32)
        for q in range(0, plan.nc, 8):        # 16-byte chunks, zero past w
            if c_lo + q < w:
                fs[:, :, q:q + 8] = feat[b, :, lo:hi + 1,
                                         c_lo + q:c_lo + q + 8]
        acc = np.zeros((k_n,) + fs.shape[1:], F32)
        for c in range(c_n):
            acc = acc + wclf[:, c, None, None] * fs[c][None]
        logits = bf16r(acc + bclf[:, None, None])
        for r in range(cnt):
            ring[:, (lo + r) % plan.nr] = logits[:, r]
            ids[(lo + r) % plan.nr] = (b, ox0, lo + r)
        nrow = min(plan.br, ho - oy0)
        xs = np.arange(ox0, min(ox0 + plan.sw, wo))
        j0, j1 = cols[0, xs] - c_lo, cols[1, xs] - c_lo
        assert j0.min() >= 0 and j1.max() < plan.nc
        best = np.full((nrow, len(xs)), -np.inf, F32)
        idx = np.zeros((nrow, len(xs)), np.int16)
        for k0 in range(0, k_n, plan.kc):
            kc = min(plan.kc, k_n - k0)
            for y in range(nrow):
                gy = oy0 + y
                r0, r1 = rows[:, gy]
                assert ids[r0 % plan.nr] == (b, ox0, r0)
                assert ids[r1 % plan.nr] == (b, ox0, r1)
                t = bf16r(rw[0, gy] * ring[k0:k0 + kc, r0 % plan.nr]
                          + rw[1, gy] * ring[k0:k0 + kc, r1 % plan.nr])
                for kk in range(kc):
                    v = t[kk, j0] * cw[0, xs] + t[kk, j1] * cw[1, xs]
                    upd = v > best[y]
                    best[y] = np.where(upd, v, best[y])
                    idx[y] = np.where(upd, k0 + kk, idx[y])
        assert (out[b, oy0:oy0 + nrow, xs[0]:xs[-1] + 1] == -1).all()
        out[b, oy0:oy0 + nrow, xs[0]:xs[-1] + 1] = idx
    assert (out >= 0).all()
    return out.astype(np.uint8)


# (B, C, h, w, K, Ho, Wo, tile, kc, grid): ragged edges over three
# segments, one class, classes in chunks, a ratio that is not an integer,
# single-entry taps (1:1), w = 8, downsampling (a band's taps skip rows),
# one block walking every column, blocks that start mid-column
CLF_WALKS = [
    (2, 5, 9, 80, 4, 33, 300, (2, 128), None, 3),
    (1, 3, 6, 16, 1, 20, 61, (4, 128), None, 2),
    (1, 4, 7, 16, 5, 26, 64, (2, 128), 2, 3),
    (2, 3, 7, 24, 3, 20, 170, (4, 128), None, 4),
    (1, 4, 8, 16, 3, 8, 16, (2, 128), None, 2),
    (2, 3, 6, 8, 4, 24, 32, (8, 128), None, 3),
    (1, 3, 20, 32, 4, 7, 9, (2, 128), None, 2),
    (2, 3, 9, 40, 3, 30, 150, (2, 128), None, 1),
    (1, 3, 9, 40, 3, 41, 150, (2, 128), None, 7),
]


@pytest.mark.parametrize("case", CLF_WALKS)
def test_clf_walk_gives_the_twin_bits(case):
    b, c, h, w, k, ho, wo, tile, kc, grid = case
    feat, wclf, bclf = exp_tail_flat.tail_inputs(b, c, h, w, k, "cpu")
    want = clf_upsample_argmax_plain(feat, wclf, bclf, (ho, wo))
    plan = clf_tail_plan(c, k, h, w, ho, wo, tile=tile)
    if kc is not None:
        plan = plan._replace(kc=kc)
    got = clf_walk(feat.float().numpy(), wclf.float().numpy(), bclf.numpy(),
                   ho, wo, plan, grid)
    assert bits_equal(torch.from_numpy(got), want)
    if k > 1:
        assert len(np.unique(got)) > 1


# ------------------------------------------------------- the entries' ints

@contextlib.contextmanager
def stood_in(monkeypatch, mod, name, n_plan, plan_at):
    """``mod.<name>`` replaced by a stand-in C entry that records its
    arguments with the plan it is handed read back as ``n_plan`` ints (the
    argument at ``plan_at``); the CUDA device switch and stream are stood
    in too (CPU tensors)."""
    calls = []

    def entry(*args):
        plan = tuple((ctypes.c_int * n_plan).from_address(args[plan_at]))
        calls.append(args[:plan_at] + (plan,) + args[plan_at + 1:])
        return 0
    monkeypatch.setattr(mod, name, lambda: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=77))
    yield calls


@pytest.mark.parametrize("k,dil,w,rows,halo", [(3, 1, 16, 5, None),
                                                (9, 2, 12, 4, 107)])
def test_tap_launch_hands_its_plan(monkeypatch, k, dil, w, rows, halo):
    halo = tap_halo(k, dil, w) if halo is None else halo
    x = torch.zeros((2, 3, rows * w + 2 * halo), dtype=torch.bfloat16)
    wt = torch.zeros((k * k, 3))
    with stood_in(monkeypatch, vf, "_tap_entry", 9, 10) as calls:
        out = vf._tap_launch(x, wt, k, dil, w, halo)
    (call,) = calls
    assert call[:3] == (x.data_ptr(), wt.data_ptr(), out.data_ptr())
    assert call[3:10] == (2, 3, rows * w, w, halo, k, dil) and call[11] == 77
    assert out.shape == (2, 3, rows * w) and out.dtype == torch.float32
    plan = tap_plan(3, k, dil, w, rows)
    assert call[10] == vf.tap_args(plan, rows * w, halo, x.data_ptr(),
                                   out.data_ptr())
    assert call[10][7] == int((rows * w + 2 * halo) % 8 == 0
                              and halo % 8 == 0 and x.data_ptr() % 16 == 0)


def test_clf_launch_hands_its_plan_and_tables(monkeypatch):
    feat, wclf, bclf = exp_tail_flat.tail_inputs(2, 5, 9, 16, 4, "cpu")
    with stood_in(monkeypatch, tf, "_clf_entry", 7, 15) as calls:
        out = tf._clf_launch(feat, wclf, bclf, (30, 61))
    (call,) = calls
    assert call[:4] == (feat.data_ptr(), wclf.data_ptr(), bclf.data_ptr(),
                        out.data_ptr())
    assert call[4:11] == (2, 5, 4, 9, 16, 30, 61) and call[16] == 77
    assert out.shape == (2, 30, 61) and out.dtype == torch.uint8
    tabs = tf._device_tables(9, 16, 30, 61, feat.device)
    assert call[11:15] == tuple(t.data_ptr() for t in tabs)
    for t, want in zip(tabs, interp_taps(9, 30, True, 30, True)
                       + interp_taps(16, 61, True, 61, True)):
        np.testing.assert_array_equal(t.numpy(), want)
    plan = clf_tail_plan(5, 4, 9, 16, 30, 61)
    assert call[15] == tf.clf_tail_args(plan, 61, out.data_ptr())
    assert call[15][6] == 0                    # 61 columns: byte stores
