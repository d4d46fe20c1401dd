"""segtpu_torch folded-BN kernels (plain versions) vs the JAX package's
Pallas kernels in interpret mode, on the CPU.

Weights come from the JAX initialisers with BatchNorm perturbed from a
numpy seed, carried into the port by ``load_jax_params`` and folded on
each side by its own ``fold_bn``. f32 outputs agree to rtol = atol =
1e-5 (f32 sums in different orders). bf16 outputs are compared as bit
patterns; each bf16 test states the share of bit-identical elements it
measured as its floor (both sides round once at the same points, so the
rare differences are f32 sum-order ties at a bf16 rounding boundary).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.core.layers import conv_bn_init
from segtpu.kernels.chw_ops import (conv_chw as jax_conv_chw,
                                    fold_bn as jax_fold_bn,
                                    inv_res_chw as jax_inv_res_chw,
                                    inv_res_s2_chw as jax_inv_res_s2_chw)
from segtpu.models.encoders import _inv_res_init

from segtpu_torch.convert import load_jax_params
from segtpu_torch.core.layers import ConvBN
from segtpu_torch.kernels.chw_ops import (
    conv_chw, conv_chw_plain, fold_bn, inv_res_chw, inv_res_chw_plain,
    inv_res_s2_chw, inv_res_s2_chw_plain, inv_res_smem, inv_res_plan,
    inv_res_plans, inv_res_cost, INV_RES_TILES, _MEASURED_PLANS)
from segtpu_torch.models.encoders import InvRes, _MBV2_CFG
from segtpu_torch.models.fast_encoder import FoldedInvRes

from test_torch_layers import _np_tree, perturb_bn

TOL = dict(rtol=1e-5, atol=1e-5)


def _bits_rate(got, want):
    """Share of bit-identical bf16 elements."""
    g = got.to(torch.bfloat16).view(torch.int16)
    w = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16).view(torch.int16)
    assert g.shape == w.shape
    return (g == w).float().mean().item()


def _conv_case(k, cin, cout, depthwise, seed):
    """Perturbed conv-bn weights: (jax folded HWIO w, bias), (port
    folded OIHW w, bias)."""
    rng = np.random.default_rng(seed)
    p, s = _np_tree(conv_bn_init(jax.random.PRNGKey(seed), k, k, cin, cout,
                                 groups=cin if depthwise else 1))
    p, s = perturb_bn(p, s, rng)
    jw, jb = jax_fold_bn(jnp.asarray(p["w"]), p["scale"], p["bias"],
                         s["mean"], s["var"])
    m = ConvBN(cin, cout, k, groups=cin if depthwise else 1,
               generator=torch.Generator().manual_seed(0))
    load_jax_params(m, p, s)
    tw, tb = fold_bn(m.w, m.scale, m.bias, m.mean, m.var)
    return (jw, jb), (tw, tb)


def test_fold_bn_matches_jax():
    """Folded weights within 4 f32 ulp: XLA's CPU rsqrt and torch's are
    each 1 ulp off the correctly rounded value on some inputs (measured
    14 % and 29 % of 1e5 variances), which the two products after it can
    grow to 4 ulp (the worst seen over 7e5 weights; 2 here). The bias,
    ``bias - mean * inv``, cancels, so it is held to an absolute 1e-7."""
    (jw, jb), (tw, tb) = _conv_case(3, 16, 24, False, 0)
    np.testing.assert_array_max_ulp(
        tw.permute(2, 3, 1, 0).numpy(), np.asarray(jw), maxulp=4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-7)


_CONV_CASES = {
    # name: (k, dilation, depthwise, act, cin, cout, hw, acc, vec)
    "stem_k2": (2, 1, False, "relu6", 12, 32, (16, 128), False, False),
    "dense_k3_dil2": (3, 2, False, "relu", 8, 12, (14, 20), False, False),
    "dw_k5": (5, 1, True, "relu", 8, 8, (12, 18), False, False),
    "pw_k1_acc": (1, 1, False, "none", 16, 8, (10, 24), True, False),
    "dense_k3_vec": (3, 1, False, "relu", 8, 8, (12, 16), False, True),
}
_JAX_RELU = {"relu6": "relu6", "relu": True, "none": False}


def _conv_inputs(case, dtype, seed):
    k, dil, dw, act, cin, cout, (h, w), use_acc, use_vec = _CONV_CASES[case]
    (jw, jb), (tw, tb) = _conv_case(k, cin, cout, dw, seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((2, cin, h, w)).astype(np.float32)
    acc = rng.standard_normal((2, cout, h, w)).astype(np.float32) \
        if use_acc else None
    vec = rng.standard_normal((2, cout)).astype(np.float32) \
        if use_vec else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_conv_chw(
        jnp.asarray(x).astype(jdt), jw, jb,
        None if acc is None else jnp.asarray(acc).astype(jdt),
        None if vec is None else jnp.asarray(vec),
        k=k, dilation=dil, depthwise=dw, relu=_JAX_RELU[act], interpret=True)
    got = conv_chw_plain(
        torch.from_numpy(x).to(dtype), tw, tb,
        None if acc is None else torch.from_numpy(acc).to(dtype),
        None if vec is None else torch.from_numpy(vec),
        k=k, dilation=dil, depthwise=dw, act=act)
    return got, want


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_conv_chw_plain_matches_pallas_f32(case):
    got, want = _conv_inputs(case, torch.float32, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_chw_plain_bf16_stem_bits():
    """Measured 99.997 % bit-identical (2x12x16x128 -> 32 channels)."""
    got, want = _conv_inputs("stem_k2", torch.bfloat16, 2)
    assert got.dtype == torch.bfloat16
    assert _bits_rate(got, want) >= 0.9999


def _block(t, cin, cout, stride, seed):
    """Perturbed inverted-residual weights: (jax folded tuple, port
    FoldedInvRes)."""
    p, s = _inv_res_init(jax.random.PRNGKey(seed), cin, cout, t, jnp.float32)
    p, s = perturb_bn(*_np_tree((p, s)), np.random.default_rng(seed))

    def jf(name):
        return jax_fold_bn(jnp.asarray(p[name]["w"]), p[name]["scale"],
                           p[name]["bias"], s[name]["mean"], s[name]["var"])

    jw = ((jf("expand") if t != 1 else (None, None)) + jf("dw")
          + jf("project"))
    blk = InvRes(cin, cout, t, stride,
                 generator=torch.Generator().manual_seed(0))
    load_jax_params(blk, p, s)
    return jw, blk


def _folded_args(fb, x):
    return (x, fb.w_exp, fb.b_exp, fb.w_dw, fb.b_dw, fb.w_proj, fb.b_proj)


def _inv_res_pair(t, cin, cout, stride, residual, dtype, seed):
    jw, blk = _block(t, cin, cout, stride, seed)
    fb = FoldedInvRes(blk, dtype)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, cin, 24, 40)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(dtype)
    if stride == 1:
        want = jax_inv_res_chw(xj, *jw, residual=residual, interpret=True)
        got = inv_res_chw_plain(*_folded_args(fb, xt), residual=residual)
    else:
        want = jax_inv_res_s2_chw(xj, *jw, interpret=True)
        got = inv_res_s2_chw_plain(*_folded_args(fb, xt))
    return got, want


@pytest.mark.parametrize("t,cin,cout,residual", [
    (6, 16, 24, False),   # expand, channel change
    (6, 32, 32, True),    # expand + residual
    (1, 32, 16, False),   # no expand (first block)
])
def test_inv_res_chw_plain_matches_pallas_f32(t, cin, cout, residual):
    got, want = _inv_res_pair(t, cin, cout, 1, residual, torch.float32, 3)
    assert got.shape == (2, cout, 24, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,cin,cout", [
    (6, 16, 24),
    (1, 32, 16),
    (6, 32, 64),
])
def test_inv_res_s2_chw_plain_matches_pallas_f32(t, cin, cout):
    got, want = _inv_res_pair(t, cin, cout, 2, False, torch.float32, 4)
    assert got.shape == (2, cout, 12, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_inv_res_chw_plain_bf16_bits():
    """Measured 99.992 % bit-identical (expand + residual, 32 -> 32)."""
    got, want = _inv_res_pair(6, 32, 32, 1, True, torch.bfloat16, 5)
    assert got.dtype == torch.bfloat16
    assert _bits_rate(got, want) >= 0.9995


def test_inv_res_s2_chw_plain_bf16_bits():
    """Measured 99.974 % bit-identical (expand, 16 -> 24)."""
    got, want = _inv_res_pair(6, 16, 24, 2, False, torch.bfloat16, 6)
    assert got.dtype == torch.bfloat16
    assert _bits_rate(got, want) >= 0.9997


def test_inv_res_border_masks_the_expand_output():
    """Zero padding applies to the dw input (the expand output): with a
    zero input and a large expand bias the border must still read 0
    through the dw, not relu6(bias)."""
    cin, cmid, cout = 4, 8, 4
    x = torch.zeros(1, cin, 6, 6)
    w_exp = torch.zeros(cmid, cin, 1, 1)
    b_exp = torch.full((cmid,), 0.5)     # relu6(0.5) = 0.5 everywhere
    w_dw = torch.ones(cmid, 1, 3, 3)
    w_proj = torch.zeros(cout, cmid, 1, 1)
    w_proj[:, 0] = 1.0
    y = inv_res_chw_plain(x, w_exp, b_exp, w_dw, torch.zeros(cmid), w_proj,
                          torch.zeros(cout))
    assert y[0, 0, 0, 0].item() == pytest.approx(4 * 0.5)   # corner: 4 taps
    assert y[0, 0, 0, 2].item() == pytest.approx(6 * 0.5)   # edge: 6 taps
    assert y[0, 0, 2, 2].item() == pytest.approx(9 * 0.5)   # interior: 9


def _mbv2_shapes(h, w):
    """(cin, cmid, cout, stride, ho, wo, expand) of the 17 blocks."""
    out, cin = [], 32
    for t, c, n, s in _MBV2_CFG:
        for i in range(n):
            st = s if i == 0 else 1
            h, w = h // st, w // st
            out.append((cin, cin * t, c, st, h, w, t != 1))
            cin = c
    return out


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("hw", [(512, 1024), (32, 48)])
def test_inv_res_tile_fits_every_encoder_block(elt, hw):
    """The host's plan for every block shape of the encoder (the
    1024x2048 frame's and a small one's) obeys the kernel's rules, and
    the 1024x2048 bf16 blocks take their measured plans."""
    dtype = torch.bfloat16 if elt == 2 else torch.float32
    for cin, cmid, cout, st, ho, wo, expand in _mbv2_shapes(*hw):
        p = inv_res_plan(cin, cmid, cout, ho, wo, st, dtype, 8, expand,
                         sm_count=132)
        assert p.rp in INV_RES_TILES[dtype]
        assert p.tw % 4 == 0 and p.mc % 4 == 0 and cmid % p.mc == 0
        assert p.th >= 1 and (p.th == 1 or p.th // 2 < ho)
        assert p.nt == -(-cout // p.rp) * (p.th * p.tw // 4) <= (
            512 if p.rp <= 12 else 256)
        assert p.smem == inv_res_smem(cin, cout, p.mc, p.th, p.tw, st, p.rp,
                                      p.pf, expand, elt) <= 227 * 1024
        if hw == (512, 1024) and elt == 2:
            assert tuple(p[:5]) == _MEASURED_PLANS[(cin, cmid, cout, st, 1)]


def test_inv_res_tile_rule_without_a_measurement():
    """A shape outside the table: the plan the cost model rates fastest of
    those that fit (mc dividing the mid width 240); a small batch on a
    small map takes a tile within twice the map's extent."""
    plans = inv_res_plans(40, 240, 40, 64, 128, 1, torch.bfloat16, True)
    p = inv_res_plan(40, 240, 40, 64, 128, 1, torch.bfloat16, 8, True,
                     sm_count=132)
    assert p == min(plans, key=lambda q: inv_res_cost(
        q, 40, 240, 40, 64, 128, 1, 8, True, 132))
    assert 240 % p.mc == 0
    p = inv_res_plan(40, 240, 40, 8, 8, 1, torch.bfloat16, 1, True,
                     sm_count=132)
    assert p.th <= 8 and p.tw <= 8


def test_wrappers_run_the_plain_version_on_cpu():
    _, blk = _block(6, 16, 24, 1, 7)
    fb = FoldedInvRes(blk, torch.float32)
    x = torch.randn(1, 16, 8, 12, generator=torch.Generator().manual_seed(0))
    before = (inv_res_chw.launches, inv_res_s2_chw.launches,
              conv_chw.launches)
    args = _folded_args(fb, x)
    assert torch.equal(inv_res_chw(*args), inv_res_chw_plain(*args))
    assert torch.equal(inv_res_s2_chw(*args), inv_res_s2_chw_plain(*args))
    w = torch.randn(8, 16, 3, 3, generator=torch.Generator().manual_seed(1))
    b = torch.zeros(8)
    assert torch.equal(conv_chw(x, w, b, k=3),
                       conv_chw_plain(x, w, b, k=3))
    assert (inv_res_chw.launches, inv_res_s2_chw.launches,
            conv_chw.launches) == before


def test_wrappers_reject_bad_input():
    _, blk = _block(6, 16, 24, 1, 8)
    fb = FoldedInvRes(blk, torch.float32)
    x = torch.randn(1, 16, 8, 12)
    with pytest.raises(ValueError, match="residual"):
        inv_res_chw(*_folded_args(fb, x), residual=True)
    with pytest.raises(ValueError, match="even"):
        inv_res_s2_chw(*_folded_args(fb, x[..., :11]))
    with pytest.raises(ValueError, match="bf16 or f32"):
        inv_res_chw(*_folded_args(fb, x.double()))
    with pytest.raises(ValueError, match="cuda or cpu"):
        inv_res_chw(*_folded_args(fb, x.to("meta")))
    w = torch.randn(8, 16, 3, 3)
    with pytest.raises(ValueError, match="k in"):
        conv_chw(x, w, torch.zeros(8), k=4)
    with pytest.raises(ValueError, match="OIHW"):
        conv_chw(x, w, torch.zeros(8), k=3, depthwise=True)
    with pytest.raises(ValueError, match="act"):
        conv_chw(x, w, torch.zeros(8), k=3, act="gelu")
