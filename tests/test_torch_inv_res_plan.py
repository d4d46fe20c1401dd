"""The CUDA-core inverted-residual kernel's plan, packed weights and entry,
on the CPU.

``csrc/inv_res.cu``'s ``inv_res_kernel`` takes its tile, mid chunk and
thread tile from ``kernels/chw_ops.py`` (``inv_res_plan``), its
shared-memory size from ``inv_res_smem`` (which the C entry checks against
its own count), and its expand and project weights packed by
``pack_inv_res``. The kernel only runs on the card. Here the plans are
held to the H100's 227 KB of shared memory, 512 or 256 threads a block and the
register cap of their instantiation at every shape the encoder launches
(the b8 1024 x 2048 blocks, space-sharded row windows with 1- and 2-row
halos, 512 x 512 and 64 x 128 frames, odd sizes, f32); the ints handed to
the C entry to the plan; and a numpy walk of the kernel's loops (its
tiles, mid chunks and channel groups, each sum in the kernel's order) to
the plain twins, bit for bit in bf16 and f32, at several plans: the
order, and so the result, does not depend on the plan.
"""

import numpy as np
import pytest
import torch

from segtpu_torch.kernels import chw_ops
from segtpu_torch.kernels.chw_ops import (
    INV_RES_TILES, InvResPlan, _MEASURED_PLANS, inv_res_args,
    inv_res_chw_plain, inv_res_plan, inv_res_plans, inv_res_regs,
    inv_res_resident, inv_res_s2_chw_plain, inv_res_smem, pack_inv_res)
from segtpu_torch.kernels.inv_res_sweep import block_shapes
from segtpu_torch.models.encoders import MobileNetV2
from segtpu_torch.models.fast_encoder import fold_encoder

SMEM = 227 * 1024
SMS = 132
BLOCKS = block_shapes(1024, 2048)
DTYPES = [torch.bfloat16, torch.float32]


def _check(cin, cmid, cout, stride, ho, wo, dtype, batch, expand):
    """The plan of one launch obeys the C entry's rules and the card's
    limits; returns it."""
    p = inv_res_plan(cin, cmid, cout, ho, wo, stride, dtype, batch, expand,
                     sm_count=SMS)
    assert isinstance(p, InvResPlan)
    assert p in inv_res_plans(cin, cmid, cout, ho, wo, stride, dtype, expand)
    assert p.rp in INV_RES_TILES[dtype] and p.pf in (0, 1)
    assert p.tw % 4 == 0 and p.tw & (p.tw - 1) == 0 and p.th >= 1
    assert p.mc % 4 == 0 and cmid % p.mc == 0
    assert p.nt == -(-cout // p.rp) * (p.th * p.tw // 4) <= (
        512 if p.rp <= 12 else 256)
    esize = 2 if dtype == torch.bfloat16 else 4
    assert p.smem == inv_res_smem(cin, cout, p.mc, p.th, p.tw, stride, p.rp,
                                  p.pf, expand, esize) <= SMEM
    regs = inv_res_regs(p.rp)
    assert p.blocks == inv_res_resident(p.nt, p.smem, regs) >= 1
    # the blocks it claims fit the SM's shared memory, threads, registers
    warps = -(-p.nt // 32)
    assert p.blocks * (p.smem + 1024) <= 228 * 1024
    assert p.blocks * warps * 32 <= 2048
    assert p.blocks * warps * 32 * regs <= 65536
    assert regs <= 255 and (regs == 128) == (p.rp <= 12)
    return p


@pytest.mark.parametrize("i", range(len(BLOCKS)))
def test_plan_fits_every_block_b8(i):
    """The 17 blocks of a bf16 b8 1024 x 2048 batch: a plan that fits, the
    one measured fastest for the block's shape."""
    cin, cmid, cout, st, h, w, expand = BLOCKS[i]
    p = _check(cin, cmid, cout, st, h // st, w // st, torch.bfloat16, 8,
               expand)
    assert tuple(p[:5]) == _MEASURED_PLANS[(cin, cmid, cout, st, 1)]


@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("i", range(len(BLOCKS)))
def test_plan_fits_shard_windows(i, halo):
    """A quarter of each block's rows plus 1 or 2 halo rows, as
    ``mbv2_chw_sharded`` hands a shard's window to the kernel (a stride-2
    window keeps an even row count), bf16 and f32."""
    cin, cmid, cout, st, h, w, expand = BLOCKS[i]
    rows = h // 4 + (2 if st == 2 else halo)
    for dt in DTYPES:
        _check(cin, cmid, cout, st, rows // st, w // st, dt, 8, expand)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", [(512, 512), (64, 128), (1024, 2048),
                                (96, 160)])
def test_plan_fits_other_frames(hw, dtype):
    """Every block at 512 x 512 (G2's frames), 64 x 128 and 96 x 160
    (widths that no tile divides deeper down), b2 and b8."""
    for cin, cmid, cout, st, h, w, expand in block_shapes(*hw):
        for batch in (2, 8):
            _check(cin, cmid, cout, st, h // st, w // st, dtype, batch,
                   expand)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [   # stride, cin, t, cout, h, w
    (1, 16, 6, 24, 13, 21), (1, 32, 6, 32, 9, 11), (1, 32, 1, 16, 17, 30),
    (2, 32, 1, 16, 14, 22), (2, 96, 6, 160, 10, 6), (1, 160, 6, 320, 3, 5),
    (1, 24, 6, 24, 13, 21), (2, 32, 6, 64, 22, 32), (1, 20, 6, 20, 7, 9)])
def test_plan_fits_odd_sizes(case, dtype):
    """The smoke test's odd forms (tiles cut by the image edge, widths no
    tile divides) and a width that is not a multiple of 8."""
    st, cin, t, cout, h, w = case
    p = _check(cin, cin * t, cout, st, h // st, w // st, dtype, 2, t != 1)
    assert p.th == 1 or p.th // 2 < h // st


def test_measured_plans_are_plans():
    """Every entry of the measured table is a plan of its block at the b8
    1024 x 2048 shapes (else the rule would ignore it): the 17 blocks at
    rate 1, and the stride-16 blocks of an output stride 16 encoder on
    its 64 x 128 map."""
    shapes = {(c, m, o, s, 1): (h // s, w // s, e)
              for c, m, o, s, h, w, e in BLOCKS}
    os16 = {key for key in _MEASURED_PLANS if key not in shapes}
    assert os16 == {(96, 576, 160, 1, 1), (160, 960, 160, 1, 2),
                    (160, 960, 320, 1, 2)}
    shapes.update({key: (64, 128, True) for key in os16})
    assert set(_MEASURED_PLANS) == set(shapes)
    for key, plan in _MEASURED_PLANS.items():
        ho, wo, e = shapes[key]
        assert plan in [tuple(p[:5]) for p in inv_res_plans(
            *key[:3], ho, wo, key[3], torch.bfloat16, e, dilation=key[4])]


def test_rule_without_a_measurement_is_the_cost_models_best():
    """A shape outside the table, and every f32 launch: the plan
    ``inv_res_cost`` rates fastest."""
    for dt, key in ((torch.bfloat16, (40, 240, 40, 1)),
                    (torch.float32, (32, 192, 32, 1))):
        cin, cmid, cout, st = key
        plans = inv_res_plans(cin, cmid, cout, 64, 128, st, dt, True)
        best = min(plans, key=lambda p: chw_ops.inv_res_cost(
            p, cin, cmid, cout, 64, 128, st, 8, True, SMS))
        assert inv_res_plan(cin, cmid, cout, 64, 128, st, dt, 8, True,
                            sm_count=SMS) == best


def test_args_hand_the_plan_to_the_entry(monkeypatch):
    """``_inv_res_launch`` hands the entry x, the packed weights, the f32
    biases and depthwise weight, the output and ``inv_res_args`` of the
    plan: shapes, (th, tw, mc, rp, pf), the flags, the shared bytes and
    the depthwise rate.
    The launch itself is stood in for (no card here)."""
    seen = []
    monkeypatch.setattr(chw_ops, "_launch",
                        lambda fn, t, *a: seen.append((fn, a)) or 0)
    monkeypatch.setattr(chw_ops, "_inv_res_entry", lambda: "entry")
    monkeypatch.setattr(chw_ops, "_sm_count", lambda dev: SMS)
    x, *ws = _block_args(1, 24, 6, 24, 12, 20, torch.bfloat16, seed=3)
    packed = pack_inv_res(ws[0], ws[4], torch.bfloat16)
    out = chw_ops._inv_res_launch(x, *ws, stride=1, residual=True,
                                  what="t", packed=packed)
    (fn, a), = seen
    plan = inv_res_plan(24, 144, 24, 12, 20, 1, torch.bfloat16, 2, True,
                        sm_count=SMS)
    assert fn == "entry" and len(a) == 8 + 16
    assert a[0] == x.data_ptr() and a[7] == out.data_ptr()
    assert (a[1], a[5]) == (packed[0].data_ptr(), packed[1].data_ptr())
    assert a[8:] == inv_res_args(plan, 2, 24, 144, 24, 12, 20, 1, True,
                                 True)
    assert a[8:] == (2, 24, 144, 24, 12, 20, 1, plan.th, plan.tw, plan.mc,
                     plan.rp, plan.pf, 1, 1, plan.smem, 1)
    # a given plan, no expand, f32, weights packed for the call
    seen.clear()
    x, *ws = _block_args(2, 32, 1, 16, 14, 22, torch.float32, seed=4)
    plan = inv_res_plans(32, 32, 16, 7, 11, 2, torch.float32, False)[0]
    chw_ops._inv_res_launch(x, *ws, stride=2, residual=False, what="t",
                            tile=plan)
    (_, a), = seen
    assert a[1] is None and a[2] is None and a[5] is not None
    assert a[8:] == (2, 32, 32, 16, 14, 22, 2, *plan[:5], 0, 0, plan.smem,
                     1)


def test_packed_weights_are_the_weights_transposed():
    """``pack_inv_res``: f32 [Cin][Cmid] and [Cmid][Cout] holding the
    compute dtype's values; the folded encoder packs them once, and the
    wrapper rejects a packed pair that does not match the block."""
    _, w_exp, _, _, _, w_proj, _ = _block_args(1, 16, 6, 24, 4, 4,
                                               torch.bfloat16, seed=5)
    pe, pp = pack_inv_res(w_exp, w_proj, torch.bfloat16)
    assert pe.shape == (16, 96) and pp.shape == (96, 24)
    assert pe.dtype == pp.dtype == torch.float32
    assert torch.equal(pe, w_exp.to(torch.bfloat16).float()[:, :, 0, 0].t())
    assert torch.equal(pp, w_proj.to(torch.bfloat16).float()[:, :, 0, 0].t())
    assert pack_inv_res(None, w_proj, torch.float32)[0] is None
    enc = fold_encoder(MobileNetV2(generator=torch.Generator().manual_seed(0)),
                       torch.bfloat16)
    for blk in enc.blocks:
        pe, pp = pack_inv_res(blk.w_exp, blk.w_proj, torch.bfloat16)
        assert torch.equal(blk.packed_proj, pp)
        assert (blk.packed_exp is None and pe is None) or torch.equal(
            blk.packed_exp, pe)
    assert "packed_proj" not in enc.state_dict().keys()
    bad = (pe, pp.t().contiguous())
    with pytest.raises(ValueError, match="packed weight"):
        chw_ops._check_inv_res_packed(bad, torch.zeros(96, 16, 1, 1),
                                      torch.zeros(24, 96, 1, 1),
                                      torch.device("cpu"), "t")
    with pytest.raises(ValueError, match="do not match"):
        chw_ops._check_inv_res_packed((None, pp), torch.zeros(96, 16, 1, 1),
                                      torch.zeros(24, 96, 1, 1),
                                      torch.device("cpu"), "t")


# ------------------------------------------------ the kernel's walk in numpy

def _block_args(stride, cin, t, cout, h, w, dtype, seed):
    """(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj) of a small block from
    a numpy seed: x and the dense weights in ``dtype``, the rest f32."""
    rng = np.random.default_rng(seed)
    cmid = cin * t

    def n(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    x = n(2, cin, h, w).to(dtype)
    w_exp = n(cmid, cin, 1, 1, scale=0.3).to(dtype) if t != 1 else None
    b_exp = n(cmid, scale=0.2) if t != 1 else None
    return (x, w_exp, b_exp, n(cmid, 1, 3, 3, scale=0.4), n(cmid, scale=0.2),
            n(cout, cmid, 1, 1, scale=0.2).to(dtype), n(cout, scale=0.2))


def _relu6(v):
    return np.minimum(np.maximum(v, np.float32(0)), np.float32(6))


def _walk(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, stride, residual,
          plan):
    """inv_res_kernel's loops in numpy f32: for each (image, th x tw
    tile) the window staged with zeros outside the image; for each chunk
    of mc mid channels the expand summed over the input channels from
    zero (a rounded product and a rounded add: in bf16 the product is
    exact, so this is the kernel's fmaf), + bias, relu6, zero outside the
    image; the depthwise over the taps row-major, + bias, relu6, rounded
    to the compute dtype; the project of each group of rp output channels
    accumulated chunk after chunk; then + bias, + residual, one rounding."""
    dt = x.dtype
    bf16 = dt == torch.bfloat16

    def rnd(a):
        if not bf16:
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt).float().numpy()
    xf = x.float().numpy()
    b, cin, h, w = xf.shape
    wd = w_dw.float().numpy().reshape(-1, 9)
    bd = b_dw.float().numpy()
    we = None if w_exp is None else w_exp.to(dt).float().numpy()[:, :, 0, 0]
    be = None if b_exp is None else b_exp.float().numpy()
    wp = w_proj.to(dt).float().numpy()[:, :, 0, 0]
    bp = b_proj.float().numpy()
    cmid, cout = wd.shape[0], wp.shape[0]
    ho, wo = h // stride, w // stride
    th, tw, mc, rp = plan.th, plan.tw, plan.mc, plan.rp
    wh, ww = stride * th + 3 - stride, stride * tw + 3 - stride
    out = np.zeros((b, cout, ho, wo), np.float32)
    for bi in range(b):
        for oy0 in range(0, ho, th):
            for ox0 in range(0, wo, tw):
                iy0, ix0 = stride * oy0 - 1, stride * ox0 - 1
                ys = np.arange(iy0, iy0 + wh)
                xs_ = np.arange(ix0, ix0 + ww)
                iny = (ys >= 0) & (ys < h)
                inx = (xs_ >= 0) & (xs_ < w)
                inside = iny[:, None] & inx[None, :]
                xs = np.zeros((cin, wh, ww), np.float32)
                xs[:, inside] = xf[bi][:, np.clip(ys, 0, h - 1)][
                    :, :, np.clip(xs_, 0, w - 1)][:, inside]
                acc = np.zeros((cout, th * tw), np.float32)
                for m0 in range(0, cmid, mc):
                    if we is None:
                        mid = xs[m0:m0 + mc]
                    else:
                        s = np.zeros((mc, wh, ww), np.float32)
                        for ci in range(cin):
                            s = s + we[m0:m0 + mc, ci, None, None] * xs[ci]
                        mid = np.where(inside, _relu6(
                            s + be[m0:m0 + mc, None, None]), np.float32(0))
                    s = np.zeros((mc, th, tw), np.float32)
                    for ky in range(3):
                        for kx in range(3):
                            tap = mid[:, ky:ky + stride * (th - 1) + 1:stride,
                                      kx:kx + stride * (tw - 1) + 1:stride]
                            s = s + wd[m0:m0 + mc, 3 * ky + kx, None,
                                       None] * tap
                    d = rnd(_relu6(s + bd[m0:m0 + mc, None, None]))
                    d = d.reshape(mc, th * tw)
                    for g0 in range(0, cout, rp):
                        for m in range(mc):
                            acc[g0:g0 + rp] = (acc[g0:g0 + rp]
                                               + wp[g0:g0 + rp, m0 + m, None]
                                               * d[m])
                y = (acc + bp[:, None]).reshape(cout, th, tw)
                if residual:
                    y = y + xs[:cout, 1:1 + th, 1:1 + tw]
                ny, nx = min(th, ho - oy0), min(tw, wo - ox0)
                out[bi, :, oy0:oy0 + ny, ox0:ox0 + nx] = y[:, :ny, :nx]
    return torch.from_numpy(out).to(dt)


WALK_CASES = [   # stride, cin, t, cout, residual, h, w
    (1, 8, 3, 8, True, 9, 13),
    (1, 12, 2, 20, False, 10, 17),
    (2, 8, 3, 12, False, 10, 14),
    (1, 16, 1, 8, False, 7, 9),
    (2, 16, 1, 8, False, 8, 18),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_matches_the_twin_at_every_plan(case, dtype):
    """The kernel's tiling, Cout groups and Cmid chunks, walked in numpy at
    three plans (the rule's, and the plans with the smallest and the
    largest tiles and chunks), give the plain twin's bits."""
    st, cin, t, cout, residual, h, w = case
    args = _block_args(st, cin, t, cout, h, w, dtype, seed=sum(case))
    cmid = cin * t
    plans = inv_res_plans(cin, cmid, cout, h // st, w // st, st, dtype,
                          t != 1)
    rule = inv_res_plan(cin, cmid, cout, h // st, w // st, st, dtype, 2,
                        t != 1, sm_count=SMS)
    small = min(plans, key=lambda p: (p.th * p.tw, p.mc, -p.rp))
    large = max(plans, key=lambda p: (p.th * p.tw, p.mc, p.rp))
    want = (inv_res_s2_chw_plain(*args) if st == 2 else
            inv_res_chw_plain(*args, residual=residual))
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for plan in dict.fromkeys((rule, small, large)):
        got = _walk(*args, st, residual, plan)
        assert torch.equal(got.view(view), want.view(view)), plan
