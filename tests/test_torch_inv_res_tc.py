"""The bf16 tensor-core inverted-residual kernel's plans, packed weights
and entry, on the CPU.

``csrc/inv_res.cu``'s ``inv_res_tc_kernel`` (entry ``inv_res_tc_chw``)
takes its tile, mid chunk and warp layout from ``kernels/chw_ops.py``
(``inv_res_tc_plan``), its shared-memory size from ``inv_res_tc_smem``
(which the C entry checks against its own layout) and its expand and
project weights packed by ``pack_weights``. The kernel only runs on the
card; here the plans are held to the H100's 227 KB of shared memory and
the register budget at every shape the encoder launches (whole frames,
space-sharded rows with their halos, 512 x 512, odd sizes), the packing
to the OIHW weights, the entry to the plain twins, and the served
encoder to the CUDA-core kernel, which no block shape leaves.
"""

import itertools

import pytest
import torch

from segtpu_torch.core.layers import ConvBN
from segtpu_torch.kernels import chw_ops
from segtpu_torch.kernels.chw_ops import (inv_res_chw, inv_res_chw_plain,
                                          inv_res_s2_chw, inv_res_s2_chw_plain,
                                          inv_res_tc_chw, inv_res_tc_layouts,
                                          inv_res_tc_plan, inv_res_tc_plans,
                                          inv_res_tc_smem, pack_weights)
from segtpu_torch.kernels.inv_res_sweep import _tiles, block_shapes
from segtpu_torch.models.encoders import MobileNetV2
from segtpu_torch.models.fast_encoder import fold_encoder

SMEM = 227 * 1024
ACC = 80                 # f32 project accumulators a thread may hold
SMS = 132                # the H100's multiprocessors
BLOCKS = block_shapes(1024, 2048)


def _check_plan(cin, cmid, cout, stride, ho, wo, batch):
    plan = inv_res_tc_plan(cin, cmid, cout, ho, wo, stride, batch,
                           sm_count=SMS)
    th, tw, mc, mt, nt16 = plan
    assert plan in inv_res_tc_plans(cin, cmid, cout, ho, wo, stride)
    # the C entry's rules: 16 nt16 WN = Cout16, WN in (1, 2, 4, 8), the
    # tile 16 mt (8 / WN) pixels, tw % 4 == 0, mc % 16 == 0 dividing cmid
    c16 = -(-cout // 16) * 16
    wn = c16 // (16 * nt16)
    assert c16 % (16 * nt16) == 0 and wn in (1, 2, 4, 8)
    assert th * tw == 16 * mt * (8 // wn) and tw % 4 == 0
    assert mc % 16 == 0 and cmid % mc == 0 and mt in (1, 2)
    assert 8 * mt * nt16 <= ACC
    assert inv_res_tc_smem(cin, mc, cout, th, tw, stride) <= SMEM
    return plan


@pytest.mark.parametrize("i", range(len(BLOCKS)))
def test_plan_fits_every_block_b8(i):
    """The 17 blocks of a b8 1024 x 2048 batch: a plan that fits, the
    one measured fastest for the block's shape."""
    cin, cmid, cout, st, h, w, _ = BLOCKS[i]
    plan = _check_plan(cin, cmid, cout, st, h // st, w // st, 8)
    assert plan == chw_ops._MEASURED_TC_TILES[(cin, cmid, cout, st)]


@pytest.mark.parametrize("i", range(len(BLOCKS)))
def test_plan_fits_space_shards(i):
    """A space-sharded block at n = 4 takes the shard's quarter of the
    rows plus its halos (``mbv2_chw_sharded``: a stride-1 block one row
    each side, none at the frame's ends; a stride-2 block two rows
    above): odd row counts, at b8 and at one frame."""
    cin, cmid, cout, st, h, w, _ = BLOCKS[i]
    rows = h // 4
    extra = (0, 2) if st == 2 else (1, 2)
    for e, batch in itertools.product(extra, (1, 8)):
        _check_plan(cin, cmid, cout, st, (rows + e) // st, w // st, batch)


@pytest.mark.parametrize("hw", [(512, 512), (64, 128), (1000, 1504)])
def test_plan_fits_other_frames(hw):
    for cin, cmid, cout, st, h, w, _ in block_shapes(*hw):
        _check_plan(cin, cmid, cout, st, h // st, w // st, 1)


@pytest.mark.parametrize("case", [  # stride, cin, t, cout, h, w
    (1, 16, 6, 24, 13, 21), (1, 32, 6, 32, 9, 11), (1, 32, 1, 16, 17, 30),
    (2, 32, 1, 16, 14, 22), (2, 96, 6, 160, 10, 6), (1, 160, 6, 320, 3, 5),
    (1, 24, 6, 24, 13, 21), (2, 32, 6, 64, 18, 32)])
def test_plan_fits_odd_forms(case):
    """chip_smoke.py's odd-size forms, the Cin 24 block and a stride-2
    block on a shard's rows with its 2-row halo among them."""
    st, cin, t, cout, h, w = case
    _check_plan(cin, cin * t, cout, st, h // st, w // st, 2)


def test_layouts_split_cout_across_warps():
    """Cout 320 is four warps of 80 channels (nt16 = 5) over 32 or 64
    pixels; 160 two warps; 16 one."""
    assert inv_res_tc_layouts(320) == [(1, 5, 32), (2, 5, 64)]
    assert inv_res_tc_layouts(160) == [(1, 5, 64), (2, 5, 128)]
    assert (1, 1, 128) in inv_res_tc_layouts(16)
    assert all(16 * nt * 8 // (p // (16 * mt)) == 32
               for mt, nt, p in inv_res_tc_layouts(24))


def test_smem_of_the_last_block_by_hand():
    """inv_res_tc_smem for 160 -> 960 -> 320 at a 4 x 8 tile, mc 32,
    counted from the layout in csrc/inv_res.cu: a 6 x 10 window (8-aligned
    staged columns 24, f32 rows of 12, a plane of 6 x 12 = 72 -> 84 floats,
    4 mod 16), Cin16 + 8 = 168, Cout16 = 320."""
    small = 4 * 2 * (288 + 2 * 32)          # two buffers: dw weights, biases
    mid = 4 * 32 * 84                       # f32 [mc][plane]
    d = 2 * 32 * (32 + 8)                   # bf16 [pixels][mc + 8]
    raw = 2 * 32 * 6 * 24                   # bf16 [32 channels][rows][24]
    xt = 2 * 64 * 168                       # bf16 [r16(60)][168]
    we = 2 * 32 * 168                       # bf16 [mc][168]
    wp = 2 * 320 * 40                       # bf16 [Cout16][mc + 8]
    want = small + max(mid + d, raw) + xt + we + wp
    assert inv_res_tc_smem(160, 32, 320, 4, 8, 1) == want == 73984


@pytest.mark.parametrize("shape", [(144, 24, 1, 1), (24, 144, 1, 1),
                                   (960, 160, 1, 1), (320, 960, 1, 1),
                                   (96, 16, 1, 1), (16, 32, 1, 1)])
def test_pack_weights_of_expand_and_project(shape):
    """An expand [Cmid, Cin] packs to [1][Cmid][Cin16] (Cin 24 -> 32 with
    zero channels), a project [Cout, Cmid] to [1][r8(Cout)][Cmid]; both
    unpack to the OIHW weight in bf16."""
    cout, cin = shape[:2]
    w = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    packed = pack_weights(w)
    np_, kc = -(-cout // 8) * 8, -(-cin // 16) * 16
    assert packed.shape == (1, np_, kc) and packed.dtype == torch.bfloat16
    assert torch.equal(packed[0, :cout, :cin, None, None],
                       w.to(torch.bfloat16))
    assert not packed[:, cout:].any() and not packed[:, :, cin:].any()


def _mobilenet():
    """A MobileNetV2 with seeded weights and BatchNorm that is not the
    identity."""
    enc = MobileNetV2(generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():       # BatchNorm that is not the identity
        for m in enc.modules():
            if isinstance(m, ConvBN):
                m.scale.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    return enc.eval()


def _encoder(dtype):
    return fold_encoder(_mobilenet(), dtype)


def _block_args(stride, cin, t, cout, dtype=torch.bfloat16, seed=4):
    gen = torch.Generator().manual_seed(seed)
    cmid = cin * t

    def rnd(*shape, scale=0.2):
        return torch.randn(shape, generator=gen) * scale
    x = rnd(1, cin, 6, 10, scale=1.0).to(dtype)
    w_exp = rnd(cmid, cin, 1, 1).to(dtype) if t != 1 else None
    b_exp = rnd(cmid) if t != 1 else None
    return (x, w_exp, b_exp, rnd(cmid, 1, 3, 3), rnd(cmid),
            rnd(cout, cmid, 1, 1).to(dtype), rnd(cout))


def _call(stride, args, packed):
    return inv_res_tc_chw(*args, stride=stride, residual=stride == 1 and
                          args[0].shape[1] == args[5].shape[0], packed=packed)


@pytest.mark.parametrize("stride,cin,t,cout", [(1, 24, 6, 24),
                                               (2, 32, 6, 64),
                                               (1, 32, 1, 16)])
def test_wrappers_check_packed_weights(stride, cin, t, cout):
    """``inv_res_tc_chw`` takes a packed weight only if it is
    ``pack_weights`` of the block's own weight in shape and dtype, on the
    plain path as on the kernel's; a right one leaves the result as it
    is."""
    args = _block_args(stride, cin, t, cout)
    w_exp, w_proj = args[1], args[5]
    right = (None if w_exp is None else pack_weights(w_exp),
             pack_weights(w_proj))
    assert torch.equal(_call(stride, args, right), _call(stride, args, None))
    bad_proj = [right[1][:, :, :-16], right[1].float(), right[1][:, :-8]]
    for bad in bad_proj:
        with pytest.raises(ValueError, match="packed weight"):
            _call(stride, args, (right[0], bad))
    if w_exp is not None:
        for bad in (right[0][:, :-8], right[0].float()):
            with pytest.raises(ValueError, match="packed weight"):
                _call(stride, args, (bad, right[1]))
    else:
        with pytest.raises(ValueError, match="without an expand"):
            _call(stride, args, (right[1], right[1]))
    with pytest.raises(ValueError, match="expand, project"):
        _call(stride, args, (right[1],))


@pytest.mark.parametrize("stride,cin,t,cout", [(1, 24, 6, 24),
                                               (1, 16, 6, 24),
                                               (2, 32, 6, 64),
                                               (1, 32, 1, 16),
                                               (2, 96, 6, 160)])
def test_tc_entry_on_cpu_is_the_twin(stride, cin, t, cout):
    """On a CPU tensor ``inv_res_tc_chw`` runs the plain twin of
    ``inv_res_chw`` (stride 1) or ``inv_res_s2_chw`` (stride 2), bit for
    bit, with packed weights or without, and launches nothing."""
    args = _block_args(stride, cin, t, cout)
    residual = stride == 1 and cin == cout
    want = (inv_res_s2_chw_plain(*args) if stride == 2 else
            inv_res_chw_plain(*args, residual=residual))
    packed = (None if args[1] is None else pack_weights(args[1]),
              pack_weights(args[5]))
    before = inv_res_tc_chw.launches
    for pk in (None, packed):
        got = inv_res_tc_chw(*args, stride=stride, residual=residual,
                             packed=pk)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert inv_res_tc_chw.launches == before


def test_tc_entry_rejects_what_the_kernel_cannot_run():
    """Stride 1 or 2 only; a residual only at stride 1 and Cin == Cout;
    the kernel's launch takes bf16 alone (checked before it touches a
    card)."""
    args = _block_args(1, 32, 6, 32)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        inv_res_tc_chw(*args, stride=3)
    with pytest.raises(ValueError, match="residual"):
        inv_res_tc_chw(*_block_args(2, 32, 6, 64), stride=2, residual=True)
    f32 = _block_args(1, 32, 6, 32, dtype=torch.float32)
    with pytest.raises(ValueError, match="takes bf16"):
        chw_ops._inv_res_tc_launch(*f32, stride=1, residual=True, what="t")


def test_folded_encoder_with_packed_weights_matches_plain_path():
    """On the CPU the folded bf16 encoder's blocks through the tensor-core
    entry, with their weights packed once, give taps bit-equal to the
    plain twins called with the OIHW weights alone, and to the encoder's
    own taps."""
    folded = _encoder(torch.bfloat16)
    x12 = torch.randn(1, 12, 32, 64,
                      generator=torch.Generator().manual_seed(5)).to(
                          torch.bfloat16)
    with torch.no_grad():
        taps = folded(x12)
        y = z = folded.stem(x12)
        want, got = [], []
        for blk, is_tap in zip(folded.blocks, folded.tap_after):
            args = (blk.w_exp, blk.b_exp, blk.w_dw, blk.b_dw, blk.w_proj,
                    blk.b_proj)
            packed = (None if blk.w_exp is None else pack_weights(blk.w_exp),
                      pack_weights(blk.w_proj))
            y = (inv_res_s2_chw_plain(y, *args) if blk.stride == 2 else
                 inv_res_chw_plain(y, *args, residual=blk.residual))
            z = inv_res_tc_chw(z, *args, stride=blk.stride,
                               residual=blk.residual, packed=packed)
            if is_tap:
                want.append(y)
                got.append(z)
    assert len(taps) == len(want) == len(got) == 4
    for a, b, ref in zip(taps, got, want):
        assert torch.equal(a.view(torch.int16), ref.view(torch.int16))
        assert torch.equal(b.view(torch.int16), ref.view(torch.int16))


def test_measured_plans_are_plans():
    """Every entry of the measured table is one of the plans of its block
    at the b8 1024 x 2048 shapes (else the rule would ignore it)."""
    shapes = {(c, m, o, s): (h // s, w // s)
              for c, m, o, s, h, w, _ in BLOCKS}
    for key, plan in chw_ops._MEASURED_TC_TILES.items():
        assert plan in inv_res_tc_plans(*key[:3], *shapes[key], key[3])


@pytest.mark.parametrize("kernel", ["cuda_cores", "tc"])
def test_sweep_covers_the_measured_tables(kernel):
    """``inv_res_sweep --kernel cuda_cores|tc`` times, for each of the 17
    b8 1024 x 2048 blocks, a list of plans that holds the rule's plan and
    the measured table's entry, so the sweep can reproduce
    ``_MEASURED_PLANS`` (the served kernel's) and ``_MEASURED_TC_TILES``."""
    table = (chw_ops._MEASURED_PLANS if kernel == "cuda_cores"
             else chw_ops._MEASURED_TC_TILES)
    rate = (1,) if kernel == "cuda_cores" else ()   # depthwise rate 1
    for cin, cmid, cout, st, h, w, _ in BLOCKS:
        tiles, rule, _ = _tiles(kernel, cin, cmid, cout, h // st, w // st,
                                st, 8, SMS)
        want = table[(cin, cmid, cout, st) + rate]
        assert rule in tiles and want in [tuple(t[:len(want)])
                                          for t in tiles]
        assert tuple(rule[:len(want)]) == want


def test_served_block_shapes_stay_on_cuda_cores(monkeypatch):
    """The folded bf16 encoder launches the CUDA-core kernel for each of
    its 17 blocks, and ``inv_res_chw``/``inv_res_s2_chw`` do so for a
    block shape MobileNet-v2 does not have: no shape reaches the
    tensor-core kernel (on the tensor cores any MobileNet-v2 block moves
    arch0's masks under the slice floor), which only ``inv_res_tc_chw``
    launches. The inverted residuals' launches are stood in for by the
    plain twin."""
    seen = []

    def cuda_cores(x, *ws, stride, residual, what, tile=None, packed=None,
                   dilation=1):
        seen.append((what, stride))
        return chw_ops._inv_res_plain(x, *ws, stride=stride,
                                      residual=residual, dilation=dilation)

    def tensor_cores(*args, **kw):
        raise AssertionError("the served path reached the tensor cores")
    real = chw_ops._use_plain
    monkeypatch.setattr(chw_ops, "_use_plain", lambda x, uk, what: (
        not uk if what.startswith("inv_res") else real(x, uk, what)))
    monkeypatch.setattr(chw_ops, "_inv_res_launch", cuda_cores)
    monkeypatch.setattr(chw_ops, "_inv_res_tc_launch", tensor_cores)
    folded = _encoder(torch.bfloat16)
    x12 = torch.randn(1, 12, 16, 32,
                      generator=torch.Generator().manual_seed(6)).to(
                          torch.bfloat16)
    with torch.no_grad():
        got = folded(x12)
        want = folded(x12, use_kernels=False)
    assert seen == [("inv_res_s2_chw" if b.stride == 2 else "inv_res_chw",
                     b.stride) for b in folded.blocks]
    assert len(seen) == 17
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    seen.clear()
    inv_res_chw(*_block_args(1, 16, 6, 24))
    inv_res_s2_chw(*_block_args(2, 32, 1, 16))
    assert seen == [("inv_res_chw", 1), ("inv_res_s2_chw", 2)]
