"""The bf16 tensor-core decoder kernels' plans and weight packing, on the CPU.

``csrc/cell.cu`` and ``csrc/pointwise.cu`` take their tile, channel chunks
and shared-memory size from ``kernels/chw_ops.py`` (``node_plan``,
``pw_plan``) and their weights packed by ``pack_weights`` (once, when the
decoder is folded). The kernels only run on the card; here the plans are
held to the H100's 227 KB of shared memory for every op of the NAS
vocabulary and every node the served genotypes launch, the packing to the
OIHW weights, and the packed weights to the calls that take them.
"""

import itertools

import pytest
import torch

import segtpu_torch.models.fast_decoder as fd
from segtpu_torch.kernels import chw_ops
from segtpu_torch.kernels.chw_ops import (node_plan, node_smem, pack_weights,
                                          pw_plan, pw_smem)
from segtpu_torch.models import ARCHS, create_segmenter
from segtpu_torch.models.fast_decoder import fold_decoder
from segtpu_torch.ops.layer_factory import _CONV_SPECS

SMEM = 227 * 1024
TWO_BLOCKS = 113 * 1024
C = 48                      # the decoder's width (agg_size)
# a genotype whose decoder reaches pair_op_chw and pw_multi_chw
G2 = [[2, [0, 1, 5, 3], [2, 1, 4, 0], [3, 2, 8, 9]], [[3, 2], [2, 4], [1, 0]]]
GENOTYPES = {**ARCHS, "G2": G2}


def _branch(op: str, c: int = C):
    k, dil, sep = _CONV_SPECS[op]
    return ("sep" if sep else "conv", c, k, dil)


def _check_node(branches, cout, limit=SMEM):
    plans, smem = node_plan(branches, cout)
    assert smem == node_smem(branches, plans, cout)
    assert 0 < smem <= limit or not any(
        kind in ("conv", "sep") for kind, *_ in branches)
    for (kind, cin, k, _), (cc, kyg) in zip(branches, plans):
        if kind == "conv":
            # 16-channel steps; one tap row per window only with cc = 16,
            # which keeps the sum order (16 channels, tap row, tap column)
            assert cc % 16 == 0 and 16 <= cc <= chw_ops._r16(cin)
            assert kyg == k or (kyg == 1 and cc == 16)
        elif kind == "sep":
            assert 1 <= cc <= cin and kyg == k and (cc % 4 == 0 or cc == cin)
    return plans, smem


@pytest.mark.parametrize("op", sorted(_CONV_SPECS))
def test_every_op_fits_alone_and_beside_any_other(op):
    partners = [_branch(o) for o in sorted(_CONV_SPECS)] + [
        ("skip", C, 1, 1), ("none", 0, 1, 1)]
    _check_node([_branch(op)], C, TWO_BLOCKS)
    for other in partners:
        _check_node([_branch(op), other], C)
    for c in (16, 19, 64, 96):     # other widths, one and two groups of 64
        _check_node([_branch(op, c)], c)
        _check_node([_branch(op, c), _branch(op, c)], c)


def _record_nodes(genotype, hw=(64, 64), dtype=torch.float32):
    """The node launches (branches, cout), 1x1 launches (cins, couts) and
    the (packed weight passed, OIHW weight) of every dense and 1x1 product
    of the folded decoder of ``genotype`` on seeded taps of an ``hw``
    frame, recorded around the kernel wrappers (their plain twins run
    here)."""
    gen = torch.Generator().manual_seed(0)
    model = create_segmenter(genotype, 19, generator=gen, device="cpu")
    dec = fold_decoder(model.decoder, dtype)
    taps = [torch.randn(1, c, hw[0] // s, hw[1] // s, generator=gen).to(dtype)
            for c, s in zip((24, 32, 96, 320), (4, 8, 16, 32))]
    nodes, pws, packs = [], [], []

    def kind_of(op):
        return ("sep", "conv")[op[0] == "conv"]

    def sep(x, w_dw, b_dw, w_pw, b_pw, acc=None, vec_acc=None, *, k,
            dilation=1, **kw):
        nodes.append(([("sep", x.shape[1], k, dilation)], w_pw.shape[0]))
        packs.append((kw.get("packed"), w_pw))
        return saved["sep_conv_chw"](x, w_dw, b_dw, w_pw, b_pw, acc, vec_acc,
                                     k=k, dilation=dilation, **kw)

    def pair(x1, w1, x2, w2, *, op1, op2, **kw):
        nodes.append(([(kind_of(op1), x1.shape[1], *op1[1:]),
                       (kind_of(op2), x2.shape[1], *op2[1:])],
                      w1[0 if op1[0] == "conv" else 2].shape[0]))
        for p, w, op in zip(kw.get("packed") or (None, None), (w1, w2),
                            (op1, op2)):
            packs.append((p, w[0 if op[0] == "conv" else 2]))
        return saved["pair_op_chw"](x1, w1, x2, w2, op1=op1, op2=op2, **kw)

    def cell(srcs, nodes_desc, collect, **kw):
        c = srcs[0].shape[1]
        for branches in nodes_desc:
            brs = [(b["kind"], c, b.get("k", 1), b.get("dil", 1))
                   for b in branches if b["kind"] != "vec"]
            nodes.append((brs or [("none", 0, 1, 1)], c))
            packs.extend((b.get("wp"), b["w" if b["kind"] == "conv" else "wpw"])
                         for b in branches if b["kind"] in ("conv", "sep"))
        return saved["cell_op_chw"](srcs, nodes_desc, collect, **kw)

    def chain(x, stages, **kw):
        pws.append(([x.shape[1]] + [w.shape[0] for w, _ in stages[:-1]],
                    [w.shape[0] for w, _ in stages]))
        packs.extend(zip(kw.get("packed") or [None] * len(stages),
                         [w for w, _ in stages]))
        return saved["pw_chain_chw"](x, stages, **kw)

    def multi(xs, ws, bias, **kw):
        pws.append(([sum(x.shape[1] for x in xs)], [ws[0].shape[0]]))
        packs.append((kw.get("packed"), torch.cat(list(ws), 1)))
        return saved["pw_multi_chw"](xs, ws, bias, **kw)

    wrappers = {"sep_conv_chw": sep, "pair_op_chw": pair,
                "cell_op_chw": cell, "pw_chain_chw": chain,
                "pw_multi_chw": multi}
    saved = {n: getattr(fd, n) for n in wrappers}
    try:
        for n, f in wrappers.items():
            setattr(fd, n, f)
        with torch.inference_mode():
            dec(taps)
    finally:
        for n, f in saved.items():
            setattr(fd, n, f)
    return nodes, pws, packs


@pytest.mark.parametrize("name", sorted(GENOTYPES))
def test_served_nodes_fit_two_blocks(name):
    """Every node and 1x1 launch of the genotype's decoder fits, leaving
    room for two blocks per SM. The plans take no image size: a launch at
    the served sizes (1024 x 2048, 512 x 512, a shard's rows) plans as
    here."""
    nodes, pws, _ = _record_nodes(GENOTYPES[name])
    assert nodes and pws
    for branches, cout in nodes:
        _check_node(branches, cout, TWO_BLOCKS)
    for cins, couts in pws:
        kc, smem = pw_plan(cins, couts)
        assert smem == pw_smem(kc, cins, couts) <= TWO_BLOCKS
        assert kc % 16 == 0 and 16 <= kc <= chw_ops._r16(cins[0])


def test_arch0_nodes_shared_memory_by_hand():
    """node_plan's bytes for two of arch0's nodes, counted from the layout
    in csrc/cell.cu (8 x 32 tile, Cout 48 -> 48 rows)."""
    sums = 4 * 48 * (256 + 4)                       # f32 branch sums
    mid, wpw = 2 * 256 * (48 + 8), 2 * 48 * (48 + 8)    # bf16
    dw = {5: 4 * (48 * 25 + 48), 3: 4 * (48 * 9 + 48)}  # f32 weights, biases
    # sep 5x5 dil 6 (a 32 x 56 window, 64 staged columns, two of them) and
    # conv 1x1 (8 x 32 window, its copy [8][32][56], two weights [48][56])
    plans, smem = node_plan([_branch("sep_conv_5x5_dil6"),
                             _branch("conv1x1")], C)
    cc = plans[0][0]
    assert plans[1] == (48, 1) and cc % 4 == 0
    sep = mid + wpw + dw[5] + 2 * 2 * cc * 32 * 64
    conv1 = 2 * (48 * 8 * 32 + 8 * 32 * 56 + 2 * 48 * 56)
    big, small = max(sep, conv1), min(sep, conv1)
    assert smem == max(big, small + sums) <= TWO_BLOCKS
    # one sep 3x3 (sep_conv_chw; a 10 x 34 window, 48 staged columns): the
    # sums reuse the staging region
    plans, smem = node_plan([_branch("sep_conv_3x3")], C)
    cc = plans[0][0]
    assert smem == max(mid + wpw + dw[3] + 2 * 2 * cc * 10 * 48, sums)


@pytest.mark.parametrize("shape", [(48, 48, 3, 3), (48, 48, 1, 1),
                                   (19, 96, 1, 1), (48, 320, 1, 1),
                                   (20, 24, 1, 1), (16, 16, 5, 5),
                                   (3, 5, 3, 3)])
def test_pack_weights_unpacks_to_oihw(shape):
    cout, cin, k, _ = shape
    w = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    packed = pack_weights(w)
    np_, kc = -(-cout // 8) * 8, -(-cin // 16) * 16
    assert packed.shape == (k * k, np_, kc) and packed.dtype == torch.bfloat16
    unpacked = packed[:, :cout, :cin].reshape(k, k, cout, cin)
    assert torch.equal(unpacked.permute(2, 3, 0, 1), w.to(torch.bfloat16))
    assert not packed[:, cout:].any() and not packed[:, :, cin:].any()
    for t, o, c in itertools.islice(
            itertools.product(range(k * k), range(cout), range(cin)), 0, None,
            7):
        assert packed[t, o, c] == w[o, c, t // k, t % k].to(torch.bfloat16)


def test_classifier_packs_19_to_24():
    w = torch.randn(19, 96, 1, 1)
    packed = pack_weights(w)
    assert packed.shape == (1, 24, 96)
    assert not packed[:, 19:].any()


def test_pw_plan_chunks_wide_inputs():
    kc, smem = pw_plan([320, 48], [48, 48])       # arch0's stride-32 chain
    assert kc < 320 and smem <= TWO_BLOCKS
    assert pw_smem(kc + 16, [320, 48], [48, 48]) > TWO_BLOCKS
    kc, smem = pw_plan([2048], [64])
    assert kc % 16 == 0 and smem <= TWO_BLOCKS
    assert pw_plan([96], [19]) == (96, pw_smem(96, [96], [19]))


@pytest.mark.parametrize("name", sorted(GENOTYPES))
def test_served_products_take_weights_packed_at_fold(name):
    """Every dense and 1x1 product of the bf16 decoder is handed the
    weight that ``fold_decoder`` packed once (the kernels pack nothing
    per call on the served path); an f32 decoder passes none."""
    _, _, packs = _record_nodes(GENOTYPES[name], dtype=torch.bfloat16)
    assert packs
    for packed, w in packs:
        assert packed is not None and torch.equal(packed, pack_weights(w))
    assert all(p is None for p, _ in _record_nodes(GENOTYPES[name])[2])


def _misshapen(packed):
    return packed[:, :, :-16] if packed.shape[2] > 16 else packed[:-1]


@pytest.mark.parametrize("wrapper", ["sep_conv_chw", "pair_op_chw",
                                     "cell_op_chw", "pw_chain_chw",
                                     "pw_multi_chw"])
def test_packed_weights_are_checked(wrapper):
    """A packed weight must be ``pack_weights`` of the call's own weight
    in shape and dtype, on the plain path as on the kernel's; a right one
    leaves the result as it is."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 32, 6, 10, generator=gen).to(torch.bfloat16)
    wdw, bdw = torch.randn(32, 1, 3, 3, generator=gen), torch.randn(32)
    wpw, b = torch.randn(24, 32, 1, 1, generator=gen), torch.randn(24)
    wc = torch.randn(24, 32, 3, 3, generator=gen)
    wn, bn = torch.randn(32, 32, 3, 3, generator=gen), torch.randn(32)

    def call(p):
        if wrapper == "sep_conv_chw":
            return chw_ops.sep_conv_chw(x, wdw, bdw, wpw, b, k=3, packed=p)
        if wrapper == "pair_op_chw":
            return chw_ops.pair_op_chw(
                x, (wc, b), x, (wdw, bdw, wpw, b), op1=("conv", 3, 1),
                op2=("sep", 3, 1), packed=(p, pack_weights(wpw)))
        if wrapper == "cell_op_chw":
            return chw_ops.cell_op_chw([x], [[{
                "kind": "conv", "entry": 0, "k": 3, "dil": 1, "w": wn,
                "b": bn, "wp": p}]], [1])
        if wrapper == "pw_chain_chw":
            return chw_ops.pw_chain_chw(x, [(wpw, b)], packed=[p])
        return chw_ops.pw_multi_chw([x[:, :16], x[:, 16:].contiguous()],
                                    [wpw[:, :16], wpw[:, 16:]], b, packed=p)

    w = {"pair_op_chw": wc, "cell_op_chw": wn}.get(wrapper, wpw)
    right = pack_weights(w)
    assert torch.equal(call(right), call(None))
    for bad in (_misshapen(right), right.float()):
        with pytest.raises(ValueError, match="packed weight"):
            call(bad)
