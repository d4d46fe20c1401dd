"""segtpu_torch decoder kernels (plain versions) vs the JAX package's
Pallas kernels in interpret mode, on the CPU: pw_chain_chw,
pw_multi_chw, sep_conv_chw, pair_op_chw, cell_op_chw, resize_chw and
upsample_argmax_flat.

Weights come from the JAX initialisers with BatchNorm perturbed from a
numpy seed, folded on each side by its own ``fold_bn`` (as in
``test_torch_chw_ops``). f32 outputs agree to rtol = atol = 1e-5 (f32
sums in different orders). bf16 outputs are compared as bit patterns at
the share each test states it measured as its floor. The TPU kernels
need lane widths that are multiples of 128 for the cell, resize and flat
tail forms, so those cases are 128 pixels wide.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from segtpu.kernels import chw_ops as jchw
from segtpu.kernels.resize_chw import resize_chw_pallas
from segtpu.kernels.upsample_argmax import \
    upsample_argmax_flat as jax_upsample_argmax_flat

from segtpu_torch.kernels.chw_ops import (
    cell_op_chw, cell_op_chw_plain, pair_op_chw, pair_op_chw_plain,
    pw_chain_chw, pw_chain_chw_plain, pw_multi_chw, pw_multi_chw_plain,
    sep_conv_chw, sep_conv_chw_plain)
from segtpu_torch.kernels.resize_chw import resize_chw, resize_chw_plain
from segtpu_torch.kernels.upsample_argmax import (
    upsample_argmax, upsample_argmax_flat, upsample_argmax_flat_plain)

from test_torch_chw_ops import TOL, _bits_rate, _conv_case


def _x(shape, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dtype)


def _pw(cin, cout, seed):
    return _conv_case(1, cin, cout, False, seed)


def _sep(k, c, cout, seed):
    """((jax w_dw, b_dw, w_pw, b_pw), (port ...))."""
    (jd, jbd), (td, tbd) = _conv_case(k, c, c, True, seed)
    (jp, jbp), (tp, tbp) = _pw(c, cout, seed + 1)
    return (jd, jbd, jp, jbp), (td, tbd, tp, tbp)


def _conv(k, cin, cout, seed):
    return _conv_case(k, cin, cout, False, seed)


# ---------------------------------------------------------------- 1x1 chains

def _chain_pair(dtype, seed):
    (ja, jba), (ta, tba) = _pw(24, 16, seed)
    (jb, jbb), (tb, tbb) = _pw(16, 16, seed + 1)
    xj, xt = _x((2, 24, 10, 12), seed + 2, dtype)
    want = jchw.pw_chain_chw(xj, [(ja, jba), (jb, jbb)], interpret=True)
    got = pw_chain_chw_plain(xt, [(ta, tba), (tb, tbb)])
    return got, want


def test_pw_chain_chw_plain_matches_pallas_f32():
    got, want = _chain_pair(torch.float32, 10)
    assert got.shape == (2, 16, 10, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pw_chain_chw_plain_bf16_bits():
    """Measured 100 % bit-identical (2x24x10x12, 24 -> 16 -> 16)."""
    got, want = _chain_pair(torch.bfloat16, 11)
    assert _bits_rate(got, want) >= 0.999


def _multi_pair(dtype, seed):
    (j1, jb), (t1, tb) = _pw(16, 7, seed)
    (j2, _), (t2, _) = _pw(8, 7, seed + 1)
    x1j, x1t = _x((2, 16, 9, 11), seed + 2, dtype)
    x2j, x2t = _x((2, 8, 9, 11), seed + 3, dtype)
    want = jchw.pw_multi_chw([x1j, x2j], [j1, j2], jb, interpret=True)
    got = pw_multi_chw_plain([x1t, x2t], [t1, t2], tb)
    return got, want


def test_pw_multi_chw_plain_matches_pallas_f32():
    got, want = _multi_pair(torch.float32, 20)
    assert got.shape == (2, 7, 9, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pw_multi_chw_plain_bf16_bits():
    """Measured 100 % bit-identical (two sources, 16 + 8 -> 7)."""
    got, want = _multi_pair(torch.bfloat16, 21)
    assert _bits_rate(got, want) >= 0.999


# ------------------------------------------------------------ sep and pair

_SEP_CASES = {
    # name: (k, dilation, acc, vec)
    "k3": (3, 1, False, False),
    "k5_dil6_acc": (5, 6, True, False),
    "k3_dil3_vec": (3, 3, False, True),
}


def _sep_pair(case, dtype, seed):
    k, dil, use_acc, use_vec = _SEP_CASES[case]
    jw, tw = _sep(k, 8, 12, seed)
    xj, xt = _x((2, 8, 20, 24), seed + 5, dtype)
    accj, acct = _x((2, 12, 20, 24), seed + 6, dtype) if use_acc else (None,
                                                                        None)
    vec = np.random.default_rng(seed).standard_normal((2, 12)).astype(
        np.float32) if use_vec else None
    want = jchw.sep_conv_chw(xj, *jw, accj,
                             None if vec is None else jnp.asarray(vec),
                             k=k, dilation=dil, interpret=True)
    got = sep_conv_chw_plain(xt, *tw, acct,
                             None if vec is None else torch.from_numpy(vec),
                             k=k, dilation=dil)
    return got, want


@pytest.mark.parametrize("case", sorted(_SEP_CASES))
def test_sep_conv_chw_plain_matches_pallas_f32(case):
    got, want = _sep_pair(case, torch.float32, 30)
    assert got.shape == (2, 12, 20, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sep_conv_chw_plain_bf16_bits():
    """Measured 100 % bit-identical (5x5 dilation 6 with acc)."""
    got, want = _sep_pair("k5_dil6_acc", torch.bfloat16, 31)
    assert _bits_rate(got, want) >= 0.999


def _pair_pair(dtype, seed):
    (jc, jcb), (tc, tcb) = _conv(3, 8, 8, seed)
    jsw, tsw = _sep(5, 8, 8, seed + 1)
    x1j, x1t = _x((2, 8, 18, 22), seed + 2, dtype)
    x2j, x2t = _x((2, 8, 18, 22), seed + 3, dtype)
    want = jchw.pair_op_chw(x1j, (jc, jcb), x2j, jsw, op1=("conv", 3, 3),
                            op2=("sep", 5, 1), interpret=True)
    got = pair_op_chw_plain(x1t, (tc, tcb), x2t, tsw, op1=("conv", 3, 3),
                            op2=("sep", 5, 1))
    return got, want


def test_pair_op_chw_plain_matches_pallas_f32():
    got, want = _pair_pair(torch.float32, 40)
    assert got.shape == (2, 8, 18, 22)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pair_op_chw_plain_bf16_bits():
    """Measured 99.98 % bit-identical (3x3 dilation-3 conv + 5x5 sep)."""
    got, want = _pair_pair(torch.bfloat16, 41)
    assert _bits_rate(got, want) >= 0.999


# -------------------------------------------------------------------- cell

def _cell_pair(dtype, seed):
    """The arch0 cell's fused suffix (nodes 1-3) over sources x, node0:
    node1 = sep5x5(x) + gap(node0) vector, node2 = conv3x3 dil3(node1)
    + sep3x3(x), node3 = sep5x5 dil6(node1) + conv1x1(node2)."""
    c = 8
    s5 = _sep(5, c, c, seed)
    c3 = _conv(3, c, c, seed + 2)
    s3 = _sep(3, c, c, seed + 3)
    s56 = _sep(5, c, c, seed + 5)
    c1 = _conv(1, c, c, seed + 7)
    xj, xt = _x((1, c, 32, 128), seed + 8, dtype)
    n0j, n0t = _x((1, c, 32, 128), seed + 9, dtype)
    vec = np.abs(np.random.default_rng(seed).standard_normal((1, c))).astype(
        np.float32)

    def nodes(side, wrap_vec):
        def sep(entry, k, dil, w):
            keys = ("wdw", "bdw", "wpw", "bpw")
            return dict(kind="sep", entry=entry, k=k, dil=dil,
                        **dict(zip(keys, w[side])))

        def conv(entry, k, dil, w):
            wk = "w_folded" if side == 0 else "w"
            bk = "bias" if side == 0 else "b"
            return {"kind": "conv", "entry": entry, "k": k, "dil": dil,
                    wk: w[side][0], bk: w[side][1]}
        return [[sep(0, 5, 1, s5), dict(kind="vec", vec=wrap_vec(vec))],
                [conv(2, 3, 3, c3), sep(0, 3, 1, s3)],
                [sep(2, 5, 6, s56), conv(3, 1, 1, c1)]]

    want = jchw.cell_op_chw([xj, n0j], nodes(0, jnp.asarray), [4],
                            interpret=True)
    assert want is not None
    got = cell_op_chw_plain([xt, n0t], nodes(1, torch.from_numpy), [4])
    return got, want


def test_cell_op_chw_plain_matches_pallas_f32():
    got, want = _cell_pair(torch.float32, 50)
    assert got.shape == (1, 8, 32, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cell_op_chw_plain_bf16_bits():
    """Measured 99.95 % bit-identical (three chained nodes, where one
    element rounded the other way spreads through the later nodes)."""
    got, want = _cell_pair(torch.bfloat16, 51)
    assert _bits_rate(got, want) >= 0.999


def test_cell_op_chw_plain_collect_sum():
    """Several collected entries: a left-to-right sum, each add rounded."""
    xt = torch.randn(1, 4, 6, 8, generator=torch.Generator().manual_seed(0))
    x2 = xt.flip(-1).contiguous()
    nodes = [[{"kind": "skip", "entry": 0}, {"kind": "skip", "entry": 1}]]
    for dt in (torch.float32, torch.bfloat16):
        a, b = xt.to(dt), x2.to(dt)
        got = cell_op_chw_plain([a, b], nodes, [0, 1, 2])
        node = (a.float() + b.float()).to(dt)
        assert torch.equal(got, (a + b) + node)


# ------------------------------------------------------------------ resize

def _resize_pair(dtype, seed, mode):
    xj, xt = _x((2, 8, 8, 32), seed, dtype)
    kw = dict(align_corners=True)
    if mode == "acc":
        aj, at = _x((2, 8, 16, 128), seed + 1, dtype)
        want = resize_chw_pallas(xj, (16, 128), aj, interpret=True, **kw)
        got = resize_chw_plain(xt, (16, 128), at, **kw)
    elif mode == "chain":
        (ja, jba), (ta, tba) = _pw(12, 8, seed + 2)
        (jb, jbb), (tb, tbb) = _pw(8, 8, seed + 3)
        rj, rt = _x((2, 12, 16, 128), seed + 4, dtype)
        want = resize_chw_pallas(xj, (16, 128), rj, ((ja, jba), (jb, jbb)),
                                 interpret=True, **kw)
        got = resize_chw_plain(xt, (16, 128),
                               acc_chain=(rt, [(ta, tba), (tb, tbb)]), **kw)
    else:
        kw = dict(align_corners=False)
        want = resize_chw_pallas(xj, (16, 128), interpret=True, **kw)
        got = resize_chw_plain(xt, (16, 128), **kw)
    return got, want


@pytest.mark.parametrize("mode", ["plain_half_pixel", "acc", "chain"])
def test_resize_chw_plain_matches_pallas_f32(mode):
    got, want = _resize_pair(torch.float32, 60, mode)
    assert got.shape == (2, 8, 16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_resize_chw_plain_bf16_bits():
    """Measured 100 % bit-identical (with the fused 1x1 chain)."""
    got, want = _resize_pair(torch.bfloat16, 61, "chain")
    assert _bits_rate(got, want) >= 0.999


# ---------------------------------------------------------------- flat tail

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_argmax_flat_plain_matches_pallas(dtype):
    """Masks of 5 classes from [2, 5, 8, 128] logits to 32x512, cropped
    to 30x500: measured 100 % equal to the Pallas kernel's in both
    dtypes (floor 99.9 %), and 100 % (f32) and 99.91 % (bf16, where the
    H-first tail rounds its H pass) equal to the H-first tail's."""
    xj, xt = _x((2, 5, 8 * 128), 70, dtype)
    want = np.asarray(jax_upsample_argmax_flat(
        xj, (8, 128), (32, 512), crop_hw=(30, 500), tile_r=8,
        interpret=True))
    got = upsample_argmax_flat_plain(xt, (8, 128), (32, 512),
                                     crop_hw=(30, 500)).numpy()
    assert got.shape == want.shape == (2, 30, 500)
    assert (got == want).mean() >= 0.999
    # the same masks as the H-first tail up to f32 ties
    four_d = upsample_argmax(xt.view(2, 5, 8, 128), (32, 512),
                             crop_hw=(30, 500)).numpy()
    assert (got == four_d).mean() >= 0.999


# ----------------------------------------------------------------- wrappers

def test_decoder_wrappers_run_the_plain_version_on_cpu():
    names = (pw_chain_chw, pw_multi_chw, sep_conv_chw, pair_op_chw,
             cell_op_chw, resize_chw, upsample_argmax_flat)
    before = [f.launches for f in names]
    _, (tw, tb) = _pw(8, 8, 80)
    _, sw = _sep(3, 8, 8, 81)
    x = torch.randn(1, 8, 6, 10, generator=torch.Generator().manual_seed(2))
    assert torch.equal(pw_chain_chw(x, [(tw, tb)]),
                       pw_chain_chw_plain(x, [(tw, tb)]))
    assert torch.equal(pw_multi_chw([x], [tw], tb),
                       pw_multi_chw_plain([x], [tw], tb))
    assert torch.equal(sep_conv_chw(x, *sw, k=3), sep_conv_chw_plain(x, *sw,
                                                                      k=3))
    ops = dict(op1=("conv", 1, 1), op2=("sep", 3, 2))
    assert torch.equal(pair_op_chw(x, (tw, tb), x, sw, **ops),
                       pair_op_chw_plain(x, (tw, tb), x, sw, **ops))
    nodes = [[{"kind": "skip", "entry": 0}, {"kind": "none"}]]
    assert torch.equal(cell_op_chw([x], nodes, [1]),
                       cell_op_chw_plain([x], nodes, [1]))
    assert torch.equal(resize_chw(x, (12, 20)), resize_chw_plain(x, (12, 20)))
    lf = x[:, :5].reshape(1, 5, 60)
    assert torch.equal(upsample_argmax_flat(lf, (6, 10), (24, 40)),
                       upsample_argmax_flat_plain(lf, (6, 10), (24, 40)))
    assert [f.launches for f in names] == before


def test_decoder_wrappers_reject_bad_input():
    _, (tw, tb) = _pw(8, 8, 90)
    _, sw = _sep(3, 8, 8, 91)
    x = torch.randn(1, 8, 6, 10)
    with pytest.raises(ValueError, match="OIHW"):
        pw_chain_chw(x, [(tw[:, :4], tb)])
    with pytest.raises(ValueError, match="sources differ"):
        pw_multi_chw([x, x[..., :5]], [tw, tw], tb)
    with pytest.raises(ValueError, match="k in"):
        sep_conv_chw(x, *sw, k=4)
    with pytest.raises(ValueError, match="wdw"):
        sep_conv_chw(x[:, :4], *sw, k=3)
    with pytest.raises(ValueError, match="'conv' or 'sep'"):
        pair_op_chw(x, (tw, tb), x, sw, op1=("gap", 1, 1), op2=("sep", 3, 1))
    with pytest.raises(ValueError, match="not yet computed"):
        cell_op_chw([x], [[{"kind": "skip", "entry": 1}]], [1])
    with pytest.raises(ValueError, match="acc or acc_chain"):
        resize_chw(x, (12, 20), torch.zeros(1, 8, 12, 20),
                   (x, [(tw, tb)]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        resize_chw(x.to("meta"), (12, 20))
    with pytest.raises(ValueError, match="does not match"):
        upsample_argmax_flat(x.reshape(1, 8, 60), (6, 11), (24, 40))
