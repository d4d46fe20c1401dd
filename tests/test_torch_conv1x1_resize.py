"""segtpu_torch's 1x1 conv_chw and chained resize_chw: the plans of their
CUDA kernels (csrc/conv_chw.cu conv1x1_kernel, csrc/resize.cu
resize_kernel), what the wrappers hand the C entries, and the plain twins
(the kernels' bits) against the JAX package's Pallas kernels in
interpret mode, on the CPU.

The plans are checked against the layout rules the C entries check
(every output channel covered once, shared memory within the card's
limit and the occupancy each kernel aims for) and, for the resize, by
walking the kernel's tiles in Python: every output pixel in exactly one
tile, every W tap inside the tile's H-pass columns.

Tolerances against the JAX kernels: f32 within rtol = 1e-6, atol = 2e-6
(f32 sums in another order, and weights folded by each package's own
``fold_bn``, up to 4 ulp apart; measured worst 1.4e-6 for the 1x1 and
1.9e-6 for a chain from 96 raw channels, on outputs near zero after sums
of terms up to ~8). bf16: the 1x1 conv bit for bit
(measured 100 %); the chained resize at the share each case measured as
its floor (XLA's dot sums a chain stage's products in its own f32 order,
so a stage's bf16 rounding differs on a few elements in 10^4: measured
99.994 % from 32 raw channels, 99.996 % from 24, 100 % from 96; worst one
bf16 rounding).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from segtpu.kernels.chw_ops import conv_chw as jax_conv_chw
from segtpu.kernels.resize_chw import resize_chw_pallas

from segtpu_torch.kernels import chw_ops
from segtpu_torch.kernels.chw_ops import (
    CONV1X1_TILES, _FOUR_BLOCKS, _SMEM_LIMIT, _TWO_BLOCKS, conv1x1_args,
    conv1x1_plan, conv1x1_smem, conv_chw, conv_chw_plain, vector_ok)
from segtpu_torch.kernels.resize_chw import (
    resize_args, resize_chw, resize_chw_plain, resize_ncol, resize_plan,
    resize_smem)
from segtpu_torch.kernels.upsample_argmax import interp_taps

from test_torch_chw_ops import _bits_rate, _conv_case

TOL = dict(rtol=1e-6, atol=2e-6)

# the decoder's launches on the arch0 b8 1024x2048 path
PATH_1X1 = [(48, 48), (48, 19)]                     # (cin, cout)
PATH_RESIZE = [(48, 64, 128, 96), (48, 128, 256, 32), (48, 256, 512, 24)]


# ------------------------------------------------------------ conv1x1 plan

@pytest.mark.parametrize("cin", [12, 48, 320])
@pytest.mark.parametrize("cout", [1, 3, 8, 19, 24, 48, 64, 96, 97, 160,
                                  320])
def test_conv1x1_plan_covers_every_output_channel_once(cin, cout):
    for esize in (2, 4):
        p = conv1x1_plan(cin, cout, esize)
        cpb = p.ng * p.co
        assert (p.co, p.px) in CONV1X1_TILES
        assert 1 <= p.ng <= 8 and 1 <= p.kc <= cin
        # the blocks along Cout cover it, the last one not empty
        assert p.groups * cpb >= cout > (p.groups - 1) * cpb
        assert p.smem == conv1x1_smem(cin, p.co, p.px, p.ng, p.kc, esize)
        assert p.smem <= _SMEM_LIMIT


@pytest.mark.parametrize("cin,cout", PATH_1X1)
def test_conv1x1_plan_on_the_path(cin, cout):
    """One block takes every output channel (each input byte is read
    once), with the plan's tile, and four blocks fit an SM."""
    p = conv1x1_plan(cin, cout, 2)
    assert p.groups == 1 and (p.co, p.px) == (12, 4)
    assert p.ng == -(-cout // 12)
    assert p.smem <= _FOUR_BLOCKS


@pytest.mark.parametrize("hw,shift,want", [
    (12 * 20, 0, 1),        # a 240-pixel plane: 16-byte rows
    (64 * 128, 0, 1),
    (37 * 70, 0, 0),        # 2590 pixels: scalar loads and stores
    (9 * 13, 0, 0),
    (12 * 20, 8, 0),        # a pointer 8 bytes off a 16-byte boundary
])
def test_conv1x1_vector_path_eligibility(hw, shift, want):
    ptrs = [4096, 8192 + shift, 12288]
    assert vector_ok(ptrs, hw) == bool(want)
    assert conv1x1_args(48, 19, hw, 2, ptrs)[6] == want


def test_conv1x1_args_hand_the_plan_to_the_entry():
    """The C entry reads (co, px, ng, kc, groups, smem, vec)."""
    p = conv1x1_plan(48, 48, 2)
    assert conv1x1_args(48, 48, 128 * 256, 2, [0, 512]) == (
        p.co, p.px, p.ng, p.kc, p.groups, p.smem, 1)
    assert conv1x1_args(48, 48, 37 * 70, 2, [0, 512])[6] == 0


# ------------------------------------------------------------- resize plan

def _cols(w, ow, ac):
    return interp_taps(w, ow, ac, ow, False)[0]


@pytest.mark.parametrize("c,w,ow,raw", PATH_RESIZE)
def test_resize_plan_on_the_path(c, w, ow, raw):
    """All 48 channels in one block, one 256-pixel tile of whole rows or
    of a row's segment, and two blocks of 256 threads (four of 128) fit
    an SM: the shared memory of the kernel's layout within 113 KB."""
    p = resize_plan(c, w, ow, (raw, c), (c, c), 2, True)
    assert p.cb == c and p.rows * p.cols == 256
    assert p.kc == min(raw, 16)
    assert p.smem == resize_smem(p.rows, p.ncol, p.cb, p.kc, (raw, c),
                                 (c, c), 2)
    assert p.smem <= _TWO_BLOCKS


@pytest.mark.parametrize("c,w,ow,cins,couts,esize", [
    (48, 64, 128, (96, 48), (48, 48), 4),
    (16, 35, 70, (16, 24, 20), (24, 20, 16), 2),
    (16, 35, 70, (16,), (16,), 4),
    (16, 35, 70, (16, 100), (100, 16), 4),
    (96, 32, 600, (), (), 2),
    (700, 128, 1024, (), (), 2),
    (48, 2, 4, (), (), 2),
])
def test_resize_plan_fits(c, w, ow, cins, couts, esize):
    p = resize_plan(c, w, ow, cins, couts, esize, True)
    assert p.cols == min(ow, 256) and 1 <= p.rows * p.cols <= 256
    assert p.rows == 1 or p.cols == ow
    assert p.ncol % 8 == 0 and 1 <= p.cb <= c
    assert p.kc == (min(cins[0], 32 // esize) if cins else 0)
    assert p.smem == resize_smem(p.rows, p.ncol, p.cb, p.kc, cins, couts,
                                 esize)
    assert p.smem <= _SMEM_LIMIT
    if c == 700:     # the H pass of 700 channels splits into blocks
        assert p.cb < c


@pytest.mark.parametrize("h,w,oh,ow,ac", [
    (64, 128, 128, 256, True), (128, 256, 256, 512, True),
    (32, 64, 64, 128, True), (19, 35, 37, 70, False), (16, 32, 40, 600, True),
    (8, 128, 16, 1024, True), (2, 2, 5, 4, True), (7, 13, 9, 31, False),
])
def test_resize_tiles_cover_the_output_and_their_columns(h, w, oh, ow, ac):
    """The kernel's tiling (resize.cu tile_of, lo = cols[ox0] & ~7): every
    output pixel in exactly one tile, both W taps of every pixel within
    the tile's ncol H-pass columns from lo."""
    p = resize_plan(48, w, ow, (), (), 2, ac)
    cols = _cols(w, ow, ac)
    assert p.ncol == resize_ncol(w, ow, ac)
    seen = np.zeros((oh, ow), np.int64)
    if p.cols == ow:
        tiles = [(i * p.rows, 0, min(p.rows, oh - i * p.rows) * ow)
                 for i in range(-(-oh // p.rows))]
    else:
        segs = -(-ow // p.cols)
        tiles = [(i // segs, (i % segs) * p.cols,
                  min(p.cols, ow - (i % segs) * p.cols))
                 for i in range(oh * segs)]
    for oy0, ox0, n in tiles:
        lo = int(cols[0, ox0]) & ~7
        f = np.arange(n)
        r, ox = f // p.cols, ox0 + f % p.cols
        assert r.max() < p.rows
        seen[oy0 + r, ox] += 1
        for k in range(2):
            j = cols[k, ox] - lo
            assert j.min() >= 0 and j.max() < p.ncol
    assert (seen == 1).all()


@pytest.mark.parametrize("w,ow,shift,want", [
    (256, 512, 0, 1), (64, 128, 0, 1),
    (35, 70, 0, 0),         # neither width a multiple of 8: scalar path
    (32, 600, 0, 1), (30, 64, 0, 0),
    (64, 128, 4, 0),        # a pointer off a 16-byte boundary
])
def test_resize_args_hand_the_plan_to_the_entry(w, ow, shift, want):
    """The C entry reads (R, S, ncol, CB, KC, smem, vec); vec needs both
    widths multiples of 8 and every pointer 16-byte aligned."""
    ptrs = [0, 256, 1024 + shift]
    p = resize_plan(48, w, ow, (24, 48), (48, 48), 2, True)
    assert resize_args(48, w, ow, [24, 48], [48, 48], 2, True, ptrs) == (
        p.rows, p.cols, p.ncol, p.cb, p.kc, p.smem, want)


# ---------------------------------------------------- twins against JAX

_CONV_1X1 = {
    # name: (cout, act, acc, vec, (h, w)); W = 20 and 13 are not
    # multiples of 8
    "cls_acc": (19, "none", True, False, (12, 20)),
    "agg_vec": (48, "relu", False, True, (12, 20)),
    "agg_acc_vec_odd": (48, "relu", True, True, (9, 13)),
}


def _conv_1x1_pair(case, dtype):
    cout, act, use_acc, use_vec, hw = _CONV_1X1[case]
    (jw, jb), (tw, tb) = _conv_case(1, 48, cout, False, 3)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 48, *hw)).astype(np.float32)
    acc = rng.standard_normal((2, cout, *hw)).astype(np.float32) \
        if use_acc else None
    vec = rng.standard_normal((2, cout)).astype(np.float32) \
        if use_vec else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_conv_chw(
        jnp.asarray(x).astype(jdt), jw, jb,
        None if acc is None else jnp.asarray(acc).astype(jdt),
        None if vec is None else jnp.asarray(vec), k=1,
        relu=act == "relu", interpret=True)
    got = conv_chw_plain(
        torch.from_numpy(x).to(dtype), tw, tb,
        None if acc is None else torch.from_numpy(acc).to(dtype),
        None if vec is None else torch.from_numpy(vec), k=1, act=act)
    return got, want


@pytest.mark.parametrize("case", sorted(_CONV_1X1))
def test_conv1x1_twin_matches_pallas_f32(case):
    got, want = _conv_1x1_pair(case, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(_CONV_1X1))
def test_conv1x1_twin_bf16_bits(case):
    """Measured 100 % bit-identical."""
    got, want = _conv_1x1_pair(case, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _bits_rate(got, want) == 1.0


# raw channels: (x h, w), output size, align_corners, bf16 floor measured
_RESIZE_CHAIN = {
    24: ((8, 64), (16, 128), True, 0.9999),
    32: ((4, 32), (8, 128), True, 0.9999),
    96: ((8, 64), (16, 128), False, 1.0),
}


def _resize_pair(raw_c, dtype):
    (h, w), (oh, ow), ac, _ = _RESIZE_CHAIN[raw_c]
    (ja, jba), (ta, tba) = _conv_case(1, raw_c, 48, False, raw_c)
    (jb, jbb), (tb, tbb) = _conv_case(1, 48, 48, False, raw_c + 1)
    rng = np.random.default_rng(raw_c)
    x = rng.standard_normal((2, 48, h, w)).astype(np.float32)
    raw = rng.standard_normal((2, raw_c, oh, ow)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = resize_chw_pallas(jnp.asarray(x).astype(jdt), (oh, ow),
                             jnp.asarray(raw).astype(jdt),
                             ((ja, jba), (jb, jbb)), align_corners=ac,
                             interpret=True)
    got = resize_chw_plain(torch.from_numpy(x).to(dtype), (oh, ow),
                           acc_chain=(torch.from_numpy(raw).to(dtype),
                                      [(ta, tba), (tb, tbb)]),
                           align_corners=ac)
    return got, want


@pytest.mark.parametrize("raw_c", sorted(_RESIZE_CHAIN))
def test_resize_chain_twin_matches_pallas_f32(raw_c):
    got, want = _resize_pair(raw_c, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("raw_c", sorted(_RESIZE_CHAIN))
def test_resize_chain_twin_bf16_bits(raw_c):
    got, want = _resize_pair(raw_c, torch.bfloat16)
    assert _bits_rate(got, want) >= _RESIZE_CHAIN[raw_c][3]
    worst = (got.float() - torch.from_numpy(
        np.array(want.astype(jnp.float32)))).abs().max().item()
    assert worst <= 2.0 ** -7 * got.float().abs().max().item()


def test_wrappers_take_the_twins_on_cpu():
    """On a CPU tensor the wrappers run the twins and launch nothing."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 48, 12, 20), generator=g).bfloat16()
    w = torch.randn((19, 48, 1, 1), generator=g).bfloat16()
    b = torch.randn(19, generator=g)
    raw = torch.randn((2, 24, 24, 40), generator=g).bfloat16()
    stages = [(torch.randn((48, 24, 1, 1), generator=g), torch.zeros(48)),
              (torch.randn((48, 48, 1, 1), generator=g), torch.zeros(48))]
    n_conv, n_resize = conv_chw.launches, resize_chw.launches
    assert torch.equal(conv_chw(x, w, b, k=1, act="none"),
                       conv_chw_plain(x, w, b, k=1, act="none"))
    assert torch.equal(resize_chw(x, (24, 40), acc_chain=(raw, stages)),
                       resize_chw_plain(x, (24, 40),
                                        acc_chain=(raw, stages)))
    assert (conv_chw.launches, resize_chw.launches) == (n_conv, n_resize)
    assert chw_ops._use_plain(x, True, "conv_chw")
