"""segtpu_torch's s2d stem (conv_chw k = 2) and upsample+argmax tail: the
plans of their CUDA kernels (csrc/conv_chw.cu conv_k2_kernel, csrc/
upsample_argmax.cu upsample_argmax_kernel), the ints the wrappers hand the
C entries, each kernel's tiling walked in Python, and the plain twins
against the JAX package's Pallas kernels in interpret mode, on the CPU.

The walks replay a kernel's blocks step by step in numpy float32 (every
product and sum rounded once, as the kernels and twins round them): the
stem's items (an output row segment), its chunks of input channels and
the two staged input rows with their 16-byte halo chunk, zero outside the
image, each thread's CO x PX tile and its left pixel; the tail's items
(a band x segment of one image), the input rows and columns each stages,
the H pass once per (class, output row, input column), each thread's 8
columns and the chunks of classes. Each walk must give its twin's bits exactly, and
touch every output once.

Against the JAX kernels: f32 within rtol = atol = 1e-5 for the stem
(XLA sums the 48 products of an output in its own f32 order; the folded
weights of the two packages are up to 4 ulp apart, test_torch_chw_ops);
bf16 at the share of bit-identical elements each case measured as its
floor (both round once at the same points; an f32 sum-order tie at a
bf16 rounding boundary moves an element by one bf16 step: measured
100 % for two cases and 99.998 % for the stem's 12 -> 32), worst one
bf16 rounding. The tail's bf16 masks bit for bit (measured); f32 masks
equal on >= 99.99 % with every other pixel a near-tie of the upsampled
f32 logits (test_torch_upsample_argmax's rule: XLA's f32 dot may fuse a
multiply-add; measured 100 %).
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from segtpu.core.resize import resize_bilinear as jax_resize
from segtpu.kernels.chw_ops import conv_chw as jax_conv_chw
from segtpu.kernels.upsample_argmax import upsample_argmax as jax_tail

from segtpu_torch.kernels import chw_ops
from segtpu_torch.kernels.chw_ops import (
    STEM_TILES, _SMEM_LIMIT, _TWO_BLOCKS, conv_chw, conv_chw_plain,
    stem_args, stem_plan, stem_row, stem_smem)
from segtpu_torch.kernels.upsample_argmax import (
    TAIL_TILES, _THREE_BLOCKS, interp_taps, tail_args, tail_plan, tail_smem,
    tail_span, upsample_argmax, upsample_argmax_plain)

from test_torch_chw_ops import _bits_rate, _conv_case
from test_torch_upsample_argmax import assert_masks_agree

ua = importlib.import_module("segtpu_torch.kernels.upsample_argmax")

F32 = np.float32

# (cin, cout, H, W) of the stem's launches: arch0 b8 1024x2048 (main),
# the 1000x1500 and 999x1501 frames padded to 1024x1504 (pad, odd), a
# quarter of the main frame with its halo row (the sharded stem), G2's
# 512x512
STEM_GEOMETRIES = {"main": (12, 32, 512, 1024), "pad": (12, 32, 512, 752),
                   "odd": (12, 32, 512, 752), "shard": (12, 32, 129, 1024),
                   "g2": (12, 32, 256, 256)}
# (h, w, grid, crop) of the tail's launches, 19 classes
TAIL_GEOMETRIES = {"main": (256, 512, (1024, 2048), None),
                   "pad": (256, 376, (1024, 1504), (1000, 1500)),
                   "odd": (256, 376, (1024, 1504), (999, 1501)),
                   "g2": (128, 128, (512, 512), None)}


# --------------------------------------------------------------- stem plan

@pytest.mark.parametrize("name", sorted(STEM_GEOMETRIES))
@pytest.mark.parametrize("esize", [2, 4])
def test_stem_plan_on_the_path(name, esize):
    """One block takes all 32 channels in 4 channel groups, over segments
    of 512 pixels (two warps a group; G2's rows of 256 take one); bf16
    stages all 12 input channels at once, f32 half of them on rows of 512 (a chunk of
    12 f32 rows would leave room for one block an SM); two blocks fit an
    SM."""
    cin, cout, h, w = STEM_GEOMETRIES[name]
    p = stem_plan(cin, cout, w, esize)
    assert (p.co, p.px) == STEM_TILES[0] == (8, 8)
    assert p.groups == 1 and p.ng == 4
    assert p.np * 32 * p.px == min(w, 512)
    assert p.kc == (6 if esize == 4 and w > 256 else 12)
    assert p.smem == stem_smem(cin, p.co, p.px, p.ng, p.np, p.kc, esize)
    assert p.smem <= _TWO_BLOCKS


@pytest.mark.parametrize("tile", STEM_TILES)
@pytest.mark.parametrize("cin,cout,w", [
    (12, 32, 1024), (12, 32, 70), (7, 19, 64), (48, 64, 100), (24, 100, 33),
    (320, 16, 512), (3, 1, 8)])
def test_stem_plan_fits_and_covers_every_channel(tile, cin, cout, w):
    for esize in (2, 4):
        p = stem_plan(cin, cout, w, esize, tile)
        cpb = p.ng * p.co
        assert (p.co, p.px) == tile
        assert 1 <= p.ng * p.np <= 8 and 1 <= p.kc <= cin
        assert p.groups * cpb >= cout > (p.groups - 1) * cpb
        # a segment no wider than the row needs beyond one thread's tile
        assert p.np == 1 or (p.np - 1) * 32 * p.px < w
        assert p.smem == stem_smem(cin, p.co, p.px, p.ng, p.np, p.kc, esize)
        assert p.smem <= _SMEM_LIMIT
        # the staged rows are whole 16-byte chunks
        assert stem_row(p.px, p.np, esize) * esize % 16 == 0


@pytest.mark.parametrize("w,shift,tile,want", [
    (1024, 0, (8, 8), 1), (752, 0, (8, 8), 1), (64, 0, (8, 8), 1),
    (70, 0, (8, 8), 0),                 # ragged width: scalar path
    (1024, 2, (8, 8), 0),               # a plane off a 16-byte boundary
    (1032, 0, (4, 16), 0),              # 16 pixels a thread, W % 16 = 8
    (1024, 0, (4, 16), 1),
])
def test_stem_args_hand_the_plan_to_the_entry(w, shift, tile, want):
    """The C entry reads (co, px, ng, np, kc, groups, smem, vec)."""
    got = stem_args(12, 32, w, 2, [4096, 8192 + shift], tile)
    assert got == tuple(stem_plan(12, 32, w, 2, tile)) + (want,)


def test_conv_launch_hands_each_form_its_plan(monkeypatch):
    """The wrapper passes stem_args's 8 ints for dense k = 2 at dilation
    1 and conv1x1_args's 7 for dense k = 1; the other forms take none."""
    calls = []

    def entry(*args):                  # the C entry's arguments, no stream
        k, plan = args[11], args[16]
        n = {1: 7, 2: 8}.get(k) if not args[13] else None
        calls.append(None if plan is None else
                     tuple((ctypes.c_int * n).from_address(plan)))
        return 0

    monkeypatch.setattr(chw_ops, "_conv_entry", lambda: entry)
    monkeypatch.setattr(chw_ops, "_launch", lambda fn, t, *a: fn(*a))
    x = torch.zeros(2, 12, 9, 16, dtype=torch.bfloat16)
    for k, dil, dw in ((2, 1, False), (2, 2, False), (2, 1, True),
                       (1, 1, False), (3, 1, False)):
        w = torch.zeros((12, 1, k, k) if dw else (32, 12, k, k))
        b = torch.zeros(12 if dw else 32)
        chw_ops._conv_launch(x, w, b, None, None, k, dil, dw, "relu")
    stem, dilated, depthwise, one, three = calls
    assert stem[:7] == tuple(stem_plan(12, 32, 16, 2)) and stem[7] in (0, 1)
    assert one[:6] == tuple(chw_ops.conv1x1_plan(12, 32, 2))
    assert dilated is depthwise is three is None


# ------------------------------------------------------------- stem walk

def _act(y, act):
    if act == "relu":
        return np.maximum(y, F32(0))
    if act == "relu6":
        return np.minimum(np.maximum(y, F32(0)), F32(6))
    return y


def _round(y, dtype):
    return torch.from_numpy(np.ascontiguousarray(y)).to(dtype)


def walk_stem(x, w, bias, acc, vec, act, plan):
    """conv_k2_kernel's work on the CPU, item by item and step by step:
    returns the output it writes, and checks that its threads tile every
    output channel and pixel of an item once and that it stores every
    output once."""
    b_n, c_n, h, wd = x.shape
    cout = w.shape[0]
    esz = x.element_size()
    e = 16 // esz                       # the halo chunk's elements
    s_w = plan.np * 32 * plan.px
    sr = e + s_w
    cpb = plan.ng * plan.co
    # thread (warp, lane) -> channels g * CO + [0, CO), pixels pix + [0, PX)
    tiles = np.zeros((cpb, s_w), np.int64)
    for t in range(32 * plan.ng * plan.np):
        warp, lane = divmod(t, 32)
        g, pw = warp % plan.ng, warp // plan.ng
        pix = pw * 32 * plan.px + lane * plan.px
        tiles[g * plan.co:(g + 1) * plan.co, pix:pix + plan.px] += 1
    assert (tiles == 1).all()
    xf = x.float().numpy()
    wf = w.to(x.dtype).float().numpy().reshape(cout, c_n, 4)
    bf = bias.float().numpy()
    accf = None if acc is None else acc.float().numpy()
    vecf = None if vec is None else vec.float().numpy()
    out = np.full((b_n, cout, h, wd), np.nan, F32)
    written = np.zeros((b_n, cout, h, wd), np.int64)
    nseg = -(-wd // s_w)
    nch = -(-c_n // plan.kc)
    for blk_y in range(plan.groups):
        co0 = blk_y * cpb
        cos = co0 + np.arange(cpb)
        live = cos < cout
        w_s = np.zeros((c_n, 4, cpb), F32)           # staged once
        w_s[:, :, live] = np.transpose(wf[cos[live]], (1, 2, 0))
        b_s = np.where(live, bf[np.minimum(cos, cout - 1)], F32(0))
        for item in range(b_n * h * nseg):
            row, seg = divmod(item, nseg)
            b, y = divmod(row, h)
            x0 = seg * s_w
            a = np.zeros((cpb, s_w), F32)
            for k in range(nch):
                cc = min(plan.kc, c_n - k * plan.kc)
                slot = np.zeros((cc, 2, sr), F32)      # rows y - 1, y
                gx = x0 - e + np.arange(sr)
                inside = (gx >= 0) & (gx < wd)
                for r in range(2):
                    if y - 1 + r >= 0:
                        slot[:, r, inside] = xf[b, k * plan.kc:
                                                k * plan.kc + cc,
                                                y - 1 + r][:, gx[inside]]
                for c in range(cc):
                    u, v = slot[c, 0, e:], slot[c, 1, e:]
                    # lane 0 reads the pixel left of its tile from the
                    # staged row, the other lanes shuffle it from lane - 1:
                    # both are staged column pix - 1
                    ul, vl = slot[c, 0, e - 1:e - 1 + s_w], \
                        slot[c, 1, e - 1:e - 1 + s_w]
                    for t, xv in enumerate((ul, u, vl, v)):
                        a = a + w_s[k * plan.kc + c, t][:, None] * xv[None]
            q = x0 + np.arange(s_w)
            keep = q < wd
            yv = _act(a + b_s[:, None], act)
            for o in np.flatnonzero(live):
                col = yv[o, keep]
                if accf is not None:
                    col = col + accf[b, co0 + o, y, q[keep]]
                if vecf is not None:
                    col = col + vecf[b, co0 + o]
                out[b, co0 + o, y, q[keep]] = col
                written[b, co0 + o, y, q[keep]] += 1
    assert (written == 1).all()
    return _round(out, x.dtype)


def _stem_operands(cin, cout, h, w, dtype, acc, vec, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, cin, h, w), generator=g).to(dtype)
    wt = (torch.randn((cout, cin, 2, 2), generator=g) * 0.2).to(dtype)
    b = torch.randn(cout, generator=g) * 0.1
    a = torch.randn((2, cout, h, w), generator=g).to(dtype) if acc else None
    v = torch.randn((2, cout), generator=g) if vec else None
    return x, wt, b, a, v


def _bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    view = torch.int16 if got.element_size() == 2 else torch.int32
    return torch.equal(got.view(view), want.view(view))


_STEM_WALKS = {
    # name: (cin, cout, h, w, act, acc, vec)
    "stem_ragged": (12, 32, 5, 70, "relu6", False, False),
    "stem_two_segments": (12, 32, 3, 520, "relu6", False, False),
    "cin7_cout19_acc": (7, 19, 4, 24, "relu", True, False),
    "cin24_cout100_vec": (24, 100, 3, 17, "none", False, True),
    "cout8_acc_vec": (5, 8, 4, 40, "relu", True, True),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(_STEM_WALKS))
def test_stem_walk_gives_the_twin_bits(case, dtype):
    cin, cout, h, w, act, acc, vec = _STEM_WALKS[case]
    x, wt, b, a, v = _stem_operands(cin, cout, h, w, dtype, acc, vec, 1)
    want = conv_chw_plain(x, wt, b, a, v, k=2, act=act)
    plan = stem_plan(cin, cout, w, x.element_size())
    assert _bits_equal(walk_stem(x, wt, b, a, v, act, plan), want)


@pytest.mark.parametrize("tile", STEM_TILES)
def test_stem_walk_every_tile_and_chunk_gives_the_same_bits(tile):
    """Every thread tile, and chunks of 5 input channels (3 chunks of the
    stem's 12, the last ragged): the sum order does not move."""
    x, wt, b, _, _ = _stem_operands(12, 32, 3, 44, torch.bfloat16, False,
                                    False, 2)
    want = conv_chw_plain(x, wt, b, k=2, act="relu6")
    p = stem_plan(12, 32, 44, 2, tile)
    p5 = p._replace(kc=5, smem=stem_smem(12, p.co, p.px, p.ng, p.np, 5, 2))
    for plan in (p, p5):
        assert _bits_equal(walk_stem(x, wt, b, None, None, "relu6", plan),
                           want)


def test_stem_walk_on_a_shard_window_gives_the_whole_rows():
    """The sharded stem's window: the shard's rows plus one halo row
    above; the walk on the window gives, rows 1.., the whole input's
    rows bit for bit (its row 0 reads the zero padding instead)."""
    x, wt, b, _, _ = _stem_operands(12, 32, 12, 48, torch.bfloat16, False,
                                    False, 3)
    whole = conv_chw_plain(x, wt, b, k=2, act="relu6")
    win = x[:, :, 5:10].contiguous()              # rows 6..9 and halo 5
    plan = stem_plan(12, 32, 48, 2)
    got = walk_stem(win, wt, b, None, None, "relu6", plan)
    assert _bits_equal(got, conv_chw_plain(win, wt, b, k=2, act="relu6"))
    assert _bits_equal(got[:, :, 1:].contiguous(),
                       whole[:, :, 6:10].contiguous())


# --------------------------------------------------------------- tail plan

@pytest.mark.parametrize("name", sorted(TAIL_GEOMETRIES))
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("ac", [True, False])
def test_tail_plan_on_the_path(name, esize, ac):
    """Bands of 4 rows x 256 columns, the 3 input rows and the 72-80
    input columns a band names, all 19 classes in one chunk, and room for
    three blocks an SM."""
    h, w, grid, crop = TAIL_GEOMETRIES[name]
    ho, wo = crop or grid
    p = tail_plan(h, w, *grid, ho, wo, ac, 19, esize)
    assert (p.br, p.sw) == TAIL_TILES[0] == (4, 256)
    assert p.kc == 19 and p.nr <= 3 and 72 <= p.nc <= 80 and p.nc % 8 == 0
    assert p.smem == tail_smem(p.br, p.nr, p.nc, p.kc, esize)
    assert p.smem <= _THREE_BLOCKS


def test_tail_span_counts_what_a_block_names():
    taps = np.array([[0, 0, 1, 2, 2, 3, 9, 9],
                     [1, 1, 2, 3, 3, 4, 10, 10]])
    # blocks of 3: taps 0..2, 2..4, 9..10 -> 3, 3, 2 rows
    assert tail_span(taps, 3) == 3
    # aligned down to 8: the last block starts at 8 and reaches 10
    assert tail_span(taps, 3, 8) == 5
    with pytest.raises(ValueError):
        tail_span(np.array([[2, 1], [2, 1]]), 2)


@pytest.mark.parametrize("tile", TAIL_TILES)
@pytest.mark.parametrize("k,esize", [(19, 2), (19, 4), (150, 4), (256, 2)])
def test_tail_plan_fits_any_class_count(tile, k, esize):
    p = tail_plan(64, 128, 256, 512, 256, 512, True, k, esize, tile)
    assert (p.br, p.sw) == tile and p.sw % 128 == 0 and p.br % 2 == 0
    assert p.br * p.sw // 8 <= 256
    assert 1 <= p.kc <= k
    assert p.smem == tail_smem(p.br, p.nr, p.nc, p.kc, esize)
    assert p.smem <= _SMEM_LIMIT
    if tail_smem(p.br, p.nr, p.nc, 1, esize) * k <= _THREE_BLOCKS:
        assert p.kc == k


@pytest.mark.parametrize("w,wo,shift_in,shift_out,esize,want", [
    (512, 2048, 0, 0, 2, (1, 1)),
    (376, 1500, 0, 0, 2, (1, 0)),     # the pad crop: wo % 8 = 4
    (13, 50, 0, 0, 4, (0, 0)),        # rows of 13 f32: no 16-byte chunks
    (12, 48, 0, 0, 4, (1, 1)),        # 12 f32 = three 16-byte chunks
    (12, 48, 0, 0, 2, (0, 1)),        # 12 bf16 is not
    (512, 2048, 8, 4, 2, (0, 0)),     # pointers off their boundaries
])
def test_tail_args_hand_the_plan_to_the_entry(w, wo, shift_in, shift_out,
                                              esize, want):
    """The C entry reads (br, sw, nr, nc, kc, smem, vin, vout)."""
    p = tail_plan(64, w, 256, wo, 256, wo, True, 19, esize)
    got = tail_args(p, w, wo, esize, 4096 + shift_in, 8192 + shift_out)
    assert got[:6] == tuple(p) and got[6:] == want


# ------------------------------------------------------------- tail walk

def walk_tail(logits, out_hw, crop_hw, ac, plan):
    """upsample_argmax_kernel's work on the CPU, item by item (a band x
    segment of one image, as its persistent blocks take them): returns
    the mask it writes, and checks that every tap an item reads lies in
    what it staged, that the threads tile the item and that every mask
    pixel is written once."""
    b_n, k_n, h, w = logits.shape
    ho, wo = crop_hw or out_hw
    bf16 = logits.dtype == torch.bfloat16
    rows, rw = interp_taps(h, out_hw[0], ac, ho, bf16)
    cols, cw = interp_taps(w, out_hw[1], ac, wo, False)
    x = logits.float().numpy()
    out = np.zeros((b_n, ho, wo), np.uint8)
    written = np.zeros((b_n, ho, wo), np.int64)
    br, sw, nr, nc = plan.br, plan.sw, plan.nr, plan.nc
    # thread t: row (t // 16) % br, columns ((t // 16) // br) * 128 + ...
    t = np.arange(br * sw // 8)
    half = t // 16
    t_row = np.repeat(half % br, 8)
    t_col = np.repeat((half // br) * 128 + (t % 16) * 8, 8) + np.tile(
        np.arange(8), len(t))
    tiles = np.zeros((br, sw), np.int64)
    np.add.at(tiles, (t_row, t_col), 1)
    assert (tiles == 1).all()
    for b in range(b_n):
        for oy0 in range(0, ho, br):
            nrow = min(br, ho - oy0)
            r_lo = rows[0, oy0]
            for ox0 in range(0, wo, sw):
                c_lo = cols[0, ox0] & ~7
                best = np.full((br, sw), -np.inf, F32)
                idx = np.zeros((br, sw), np.uint8)
                ox = ox0 + t_col
                live = (ox < wo) & (t_row < nrow)
                oxl = np.minimum(ox, wo - 1)
                j0, j1 = cols[0, oxl] - c_lo, cols[1, oxl] - c_lo
                assert (j0[live] >= 0).all() and (j1[live] < nc).all()
                for k0 in range(0, k_n, plan.kc):
                    kc = min(plan.kc, k_n - k0)
                    xs = np.zeros((kc, nr, nc), F32)   # zero outside
                    n_r, n_c = min(nr, h - r_lo), min(nc, w - c_lo)
                    xs[:, :n_r, :n_c] = x[b, k0:k0 + kc, r_lo:r_lo + n_r,
                                          c_lo:c_lo + n_c]
                    tb = np.full((kc, br, nc), np.nan, F32)
                    for r in range(nrow):
                        gy = oy0 + r
                        i0, i1 = rows[0, gy] - r_lo, rows[1, gy] - r_lo
                        assert 0 <= i0 < nr and 0 <= i1 < nr
                        v = rw[0, gy] * xs[:, i0] + rw[1, gy] * xs[:, i1]
                        if bf16:
                            v = torch.from_numpy(v).bfloat16().float().numpy()
                        tb[:, r] = v
                    for kk in range(kc):
                        row_t = tb[kk, t_row]
                        n = np.arange(len(t_row))
                        v = (row_t[n, j0] * cw[0, oxl]
                             + row_t[n, j1] * cw[1, oxl])
                        upd = live & (v > best[t_row, t_col])
                        best[t_row[upd], t_col[upd]] = v[upd]
                        idx[t_row[upd], t_col[upd]] = k0 + kk
                out[b, oy0 + t_row[live], ox[live]] = idx[t_row[live],
                                                          t_col[live]]
                written[b, oy0 + t_row[live], ox[live]] += 1
    assert (written == 1).all()
    return torch.from_numpy(out)


_TAIL_WALKS = {
    # name: (shape, grid, crop)
    "odd_scale": ((2, 5, 9, 13), (40, 50), None),
    "x4_crop": ((1, 19, 16, 32), (64, 128), (60, 100)),
    "pad_ragged_crop": ((1, 7, 24, 36), (96, 144), (90, 141)),
    "two_segments": ((1, 3, 8, 80), (32, 320), None),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("case", sorted(_TAIL_WALKS))
def test_tail_walk_gives_the_twin_bits(case, ac, dtype):
    shape, grid, crop = _TAIL_WALKS[case]
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to(dtype)
    want = upsample_argmax_plain(x, grid, crop_hw=crop, align_corners=ac)
    ho, wo = crop or grid
    plan = tail_plan(shape[2], shape[3], *grid, ho, wo, ac, shape[1],
                     x.element_size())
    assert torch.equal(walk_tail(x, grid, crop, ac, plan), want)


@pytest.mark.parametrize("tile", TAIL_TILES)
def test_tail_walk_every_tile_and_class_chunk_gives_the_same_bits(tile):
    """Every (BR, SW) tile, and chunks of 4 of 19 classes (the last
    ragged): ties still go to the lower class across chunks."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, 19, 16, 32), generator=g).bfloat16()
    x[:, 7] = x[:, 3]                 # exact ties across two chunks
    want = upsample_argmax_plain(x, (64, 128), crop_hw=(61, 125))
    p = tail_plan(16, 32, 64, 128, 61, 125, True, 19, 2, tile)
    p4 = p._replace(kc=4, smem=tail_smem(p.br, p.nr, p.nc, 4, 2))
    for plan in (p, p4):
        assert torch.equal(walk_tail(x, (64, 128), (61, 125), True, plan),
                           want)


# ---------------------------------------------------- twins against JAX

_STEM_JAX = {
    # name: (cin, cout, act, (h, w), bf16 bit-identical floor measured);
    # W = 70 and 13 are not multiples of 8
    "stem_ragged": (12, 32, "relu6", (9, 70), 0.99997),
    "cin7_cout19": (7, 19, "relu", (12, 24), 1.0),
    "cin16_cout8_odd": (16, 8, "none", (7, 13), 1.0),
}
_JAX_RELU = {"relu6": "relu6", "relu": True, "none": False}


def _stem_pair(case, dtype):
    cin, cout, act, hw, _ = _STEM_JAX[case]
    (jw, jb), (tw, tb) = _conv_case(2, cin, cout, False, cin + cout)
    x = np.random.default_rng(cin).standard_normal(
        (2, cin, *hw)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_conv_chw(jnp.asarray(x).astype(jdt), jw, jb, k=2,
                        relu=_JAX_RELU[act], interpret=True)
    got = conv_chw_plain(torch.from_numpy(x).to(dtype), tw, tb, k=2, act=act)
    return got, want


@pytest.mark.parametrize("case", sorted(_STEM_JAX))
def test_stem_twin_matches_pallas_f32(case):
    got, want = _stem_pair(case, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(_STEM_JAX))
def test_stem_twin_bf16_bits(case):
    got, want = _stem_pair(case, torch.bfloat16)
    assert _bits_rate(got, want) >= _STEM_JAX[case][4]
    ref = torch.from_numpy(np.array(want.astype(jnp.float32)))
    worst = (got.float() - ref).abs().max().item()
    assert worst <= 2.0 ** -7 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("case", ["x4_crop", "pad_ragged_crop"])
def test_tail_twin_matches_pallas(case, ac, dtype):
    shape, grid, crop = _TAIL_WALKS[case]
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        x = np.asarray(xj.astype(jnp.float32))
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jax_tail(xj, grid, crop_hw=crop, align_corners=ac,
                               channel_first=True, tile_h=32,
                               interpret=True))
    got = upsample_argmax_plain(xt, grid, crop_hw=crop,
                                align_corners=ac).numpy()
    ho, wo = crop or grid
    up = np.asarray(jax_resize(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                               grid, align_corners=ac))
    up = np.transpose(up, (0, 3, 1, 2))[:, :, :ho, :wo]
    if dtype == "bfloat16":         # measured bit for bit
        np.testing.assert_array_equal(got, want)
    assert_masks_agree(got, want, up)


# ------------------------------------------------------------- wrappers

def test_wrappers_take_the_twins_on_cpu():
    """On a CPU tensor the stem and the tail run their twins and launch
    nothing; each C entry is made once, and a shard's tables are
    uploaded once (the sharded tail launches the H-first entry)."""
    x, wt, b, _, _ = _stem_operands(12, 32, 6, 40, torch.bfloat16, False,
                                    False, 5)
    logits = torch.randn((1, 19, 8, 16)).bfloat16()
    n_conv, n_tail = conv_chw.launches, upsample_argmax.launches
    assert torch.equal(conv_chw(x, wt, b, k=2, act="relu6"),
                       conv_chw_plain(x, wt, b, k=2, act="relu6"))
    assert torch.equal(upsample_argmax(logits, (32, 64)),
                       upsample_argmax_plain(logits, (32, 64)))
    assert (conv_chw.launches, upsample_argmax.launches) == (n_conv, n_tail)
    for entry in (ua._tail_entry, ua._shard_tables, ua._flat_entry):
        assert hasattr(entry, "cache_info")
