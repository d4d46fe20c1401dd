"""Analytic roofline of the served inference call on an H100 (counterpart:
segtpu/utils/roofline.py).

Walks the MobileNet-v2 encoder and a micro decoder genotype at one frame
size and returns, per segment and (``detail=True``) per kernel: the
operations, the least HBM bytes (each tensor written once, read once),
the binding resource and the least time on the card, at the rates of
``segtpu_torch.scripts`` (``HBM_BYTES_PER_S``, ``BF16_FLOP_PER_S``,
``F32_FLOP_PER_S``: the H100 SXM data sheet). ``segtpu_torch.bench``
reports ``pct_of_roofline`` and ``pct_of_attainable`` from it.

The workload of the encoder (stem and inverted residuals) and of the
decoder is the JAX package's walk, term for term: it is the model's
arithmetic. The front and the tail are counted as the port's kernels
compute them (``front_work``, ``tail_work``, which ``chip_smoke.py``'s
bounds also use): the front normalizes and packs by space-to-depth with
no product, and the tail interpolates two taps a pass and compares, in
the H-first or the W-first form the engine serves (``flat_tail_profitable``).
The JAX package's front and tail counts are its TPU layouts' (permutation
matmuls, dense interpolation matrices) and are not carried over.

Two ceilings:

* ``roofline_ips``: every operation at the bf16 tensor-core peak, every
  byte at the HBM rate, each segment the larger of the two.
* ``attainable_ips``: each term charged to the unit its served route
  runs on, the units overlapping (a kernel's time is the largest of its
  bytes, its tensor-core and its CUDA-core terms). On the CUDA cores, at
  the f32 rate: the encoder's ``inv_res_kernel`` and stem
  (``conv_k2_kernel``), the 1x1s of ``conv1x1_kernel``, the 1x1 chains
  ``resize_kernel`` carries, the depthwise half of every separable
  convolution, a dense cell op a node launches alone (``conv_chw``) and
  the tails. On the tensor cores, at the bf16 peak: ``node_tc_kernel``
  (the cells' other dense and their pointwise products) and
  ``pw_tc_kernel`` (the deferred adapt chains, a classifier over several
  entries). The decoder's bytes are those of its per-node launches
  (``cell_op_chw`` launches once a node and keeps no whole cell on
  chip): a node reads each input it has and writes once, the cell's
  collect reads its entries and writes once.

Against the JAX module: ``vpu_gflop`` is ``cuda_core_gflop`` (the work
on the CUDA cores, beside ``tensor_core_gflop``; a segment's attainable
bytes are ``attain_mb``, a block's ``mb``), ``peak_vpu_f32_tflops``
is ``peak_f32_tflops``, a segment's ``bound`` is "tensor cores" or
"HBM", and the front's segment is "front: normalize+s2d" (no matmul).
A measured rate above ``attainable_ips`` means a count here is wrong.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from segtpu_torch.scripts import (BF16_FLOP_PER_S, F32_FLOP_PER_S,
                                  HBM_BYTES_PER_S)

BPE = 2    # bf16 activations, as served


def front_work(h: int, w: int, n: int = 1, esize: int = BPE):
    """(bytes, dot products, f32 operations) of the front kernel on n
    frames of h x w (stride multiples): the uint8 frame read once, the
    12-channel half-size output written once, one multiply and one add
    an output element."""
    out = n * 12 * (h // 2) * (w // 2)
    return n * h * w * 3 + out * esize, 0, 2 * out


def tail_work(h: int, w: int, k: int, n: int = 1, esize: int = BPE,
              flat: bool = False):
    """(bytes, dot products, f32 operations) of the tail from [n, k, h/4,
    w/4] logits to an n x h x w uint8 mask: the logits read once, the
    mask written once. H-first: 2 multiplies and 1 add per (class,
    output row, input column), then per (class, output pixel) the W pass
    (2 multiplies, 1 add) and 1 compare. W-first (``flat``): the W pass
    per (class, input row, output column), the H pass and the compare per
    (class, output pixel)."""
    qh, qw = h // 4, w // 4
    nbytes = n * k * qh * qw * esize + n * h * w
    if flat:
        return nbytes, 0, n * k * w * (3 * qh + 4 * h)
    return nbytes, 0, n * k * h * (3 * qw + 4 * w)


def _ms(gflop: float, rate: float) -> float:
    return gflop * 1e12 / rate


def _attain_ms(mb: float, tc_g: float, cc_g: float) -> float:
    return max(mb * 1e9 / HBM_BYTES_PER_S, _ms(tc_g, BF16_FLOP_PER_S),
               _ms(cc_g, F32_FLOP_PER_S))


def _segment(name: str, gflop: float, mb: float, note: str = "", *,
             tc_g: float = 0.0, cc_g: float = 0.0,
             attain_mb: float | None = None) -> Dict:
    t_op = _ms(gflop, BF16_FLOP_PER_S)
    t_mem = mb * 1e9 / HBM_BYTES_PER_S
    attain_mb = mb if attain_mb is None else attain_mb
    return {"name": name, "gflop": gflop, "mb": mb,
            "bound": "tensor cores" if t_op > t_mem else "HBM",
            "achievable_ms": max(t_op, t_mem),
            "attain_ms": _attain_ms(attain_mb, tc_g, cc_g),
            "attain_mb": attain_mb, "tensor_core_gflop": tc_g,
            "cuda_core_gflop": cc_g, "note": note}


def _block(name: str, gflop: float, mb: float, tc_g: float, cc_g: float):
    return {"name": name, "attain_ms": _attain_ms(mb, tc_g, cc_g),
            "gflop": gflop, "mb": mb, "tensor_core_gflop": tc_g,
            "cuda_core_gflop": cc_g}


def _collect_inds(cell) -> List[int]:
    used = {0}
    for p1, p2, _, _ in cell[1:]:
        used.update((p1, p2))
    return [i for i in range(len(cell) + 1) if i not in used]


def cell_conv_units(cell) -> List[str | None]:
    """Which unit runs each convolution of a micro cell, in the order of
    its ops (node 0's, then each node's two): "tc" where
    ``node_tc_kernel`` does (a separable op anywhere; a dense one in
    ``cell_op_chw`` or ``pair_op_chw``), "cc" for a dense op a node
    launches alone on ``conv_chw``'s CUDA-core kernel (a node before the
    fused suffix whose partner is no convolution), None for the rest.
    ``FoldedMicroDecoder._cell_plan`` with one repeat an op."""
    from segtpu_torch.ops.layer_factory import OP_NAMES, _CONV_SPECS
    names = [OP_NAMES[cell[0]]] + [OP_NAMES[o] for nd in cell[1:]
                                   for o in nd[2:]]
    srcs = [0] + [p for nd in cell[1:] for p in nd[:2]]
    nodes = [[0]] + [[2 * i - 1, 2 * i] for i in range(1, len(cell))]
    start = max([src for src, n in zip(srcs, names)
                 if n == "global_average_pool"], default=0)
    fused_from = start if start < len(nodes) else len(nodes)
    units: List[str | None] = [None] * len(names)
    for ni, ks in enumerate(nodes):
        paired = ni > 0 and all(names[k] in _CONV_SPECS for k in ks)
        for k in ks:
            if names[k] in _CONV_SPECS:
                units[k] = "tc" if (_CONV_SPECS[names[k]][2] or paired
                                    or ni >= fused_from) else "cc"
    return units


def decoder_1x1_units(genotype, taps_hw) -> Tuple[List[str], List[tuple],
                                                  str]:
    """Which unit runs each 1x1 of the folded micro decoder
    (``models.fast_decoder.FoldedMicroDecoder``), "tc" (``pw_tc_kernel``)
    or "cc" (``conv1x1_kernel``, or the chain inside ``resize_kernel``):
    (each tap's adapt, each block's two aggregate 1x1s in conns order,
    the classifier). A tap that one aggregate branch reads and the head
    does not collect defers its adapt into that branch's chain."""
    _, conns = genotype
    n_taps = len(taps_hw)
    used = {i for c in conns for i in c}
    collect = [i for i in range(n_taps + len(conns)) if i not in used]
    uses = [sum(idx == i for c in conns for idx in c) + (i in collect)
            for i in range(n_taps)]
    lazy = [uses[i] == 1 and i not in collect for i in range(n_taps)]
    adapt = ["cc"] * n_taps
    aggs = []
    hw = list(taps_hw)
    for i, j in conns:
        bh, bw = max(hw[i][0], hw[j][0]), max(hw[i][1], hw[j][1])
        units = {}
        br = [i, j]
        if hw[j] == (bh, bw) and hw[i] != (bh, bw):
            br.reverse()
        e1, e2 = br
        for e in (e1, e2):
            units[e] = "cc"
            if e < n_taps and lazy[e]:
                units[e] = "tc"                       # pw_chain_chw
        if e1 < n_taps and lazy[e1] and hw[e1] == (bh, bw) \
                and hw[e2] != (bh, bw):
            units[e1] = "cc"                          # resize_kernel's chain
        for e in (i, j):
            if e < n_taps and lazy[e]:
                adapt[e] = units[e]
        aggs.append((units[i], units[j]))
        hw.append((bh, bw))
    return adapt, aggs, "cc" if len(collect) == 1 else "tc"


def compute_roofline(h: int, w: int, arch: str = "arch0",
                     num_classes: int = 19, agg: int = 48,
                     detail: bool = False) -> Dict:
    """Per-frame model at h x w (stride-32 multiples). Returns
    ``segments``, ``total_ms``, ``roofline_ips``, ``attainable_ms``,
    ``attainable_ips``, ``gflop_total`` (operations a frame), ``blocks``
    (with ``detail``: per kernel, named as the JAX module names them:
    front, stem, b0-s1, b1-s2, ..., dec-adapts, cell@1/4, clf, tail) and
    the rates in TFLOP/s and GB/s."""
    from segtpu_torch.kernels.upsample_argmax import flat_tail_profitable
    from segtpu_torch.models import ARCHS
    from segtpu_torch.models.encoders import _MBV2_CFG
    from segtpu_torch.ops.layer_factory import OP_NAMES, _CONV_SPECS

    bpe = BPE
    segs: List[Dict] = []
    blocks: List[Dict] = []

    # --- front: normalize + space-to-depth (front kernel) ---
    nbytes, _, ops = front_work(h, w)
    segs.append(_segment("front: normalize+s2d", ops / 1e9, nbytes / 1e6,
                         "front kernel, CUDA cores", cc_g=ops / 1e9))

    # --- encoder stem (conv_k2_kernel, CUDA cores) ---
    px = h * w
    ph, pw_ = h // 2, w // 2
    stem_f = 2 * ph * pw_ * (2 * 2 * 12) * 32 / 1e9
    stem_b = (px // 4 * 12 * bpe + ph * pw_ * 32 * bpe) / 1e6
    segs.append(_segment("encoder stem 2x2x12->32", stem_f, stem_b,
                         "conv_k2_kernel, CUDA cores", cc_g=stem_f))
    if detail:
        blocks.append(_block("stem", stem_f, stem_b, 0.0, stem_f))

    # --- encoder inverted residuals (inv_res_kernel, CUDA cores) ---
    cin, eh, ew = 32, ph, pw_
    enc_f = enc_b = 0.0
    for bi, (t, c, n, s) in enumerate(_MBV2_CFG):
        for i in range(n):
            stride = s if i == 0 else 1
            mid = cin * t
            oh, ow = eh // stride, ew // stride
            f_exp = 2 * eh * ew * cin * mid / 1e9 if t != 1 else 0.0
            f_dw = 2 * 9 * oh * ow * mid / 1e9
            f_prj = 2 * oh * ow * mid * c / 1e9
            b = (eh * ew * cin + oh * ow * c) * bpe / 1e6
            f = f_exp + f_dw + f_prj
            enc_f += f
            enc_b += b
            if detail:
                blocks.append(_block(
                    f"b{bi}-s{stride}" + (f".{i}" if n > 1 and stride == 1
                                          else ""), f, b, 0.0, f))
            cin, eh, ew = c, oh, ow
    segs.append(_segment("encoder inv-res blocks (fused)", enc_f, enc_b,
                         "inv_res_kernel, CUDA cores; the expanded tensor "
                         "stays on chip", cc_g=enc_f))

    # --- decoder (per genotype) ---
    genotype = ARCHS[arch]
    cell, conns = genotype
    taps_hw = [(h // 4, w // 4), (h // 8, w // 8), (h // 16, w // 16),
               (h // 32, w // 32)]
    tap_ch = [24, 32, 96, 320]
    adapt_u, agg_u, head_u = decoder_1x1_units(genotype, taps_hw)
    dec_f = dec_b = dec_b_att = dec_tc = dec_cc = 0.0
    ad_tc = ad_cc = ad_b = 0.0
    for (th, tw), c, u in zip(taps_hw, tap_ch, adapt_u):
        f = 2 * th * tw * c * agg / 1e9
        ad_tc += f if u == "tc" else 0.0
        ad_cc += f if u == "cc" else 0.0
        ad_b += th * tw * (c + agg) * bpe / 1e6
    dec_f += ad_tc + ad_cc
    dec_tc, dec_cc, dec_b, dec_b_att = ad_tc, ad_cc, ad_b, ad_b
    if detail:
        blocks.append(_block("dec-adapts", ad_tc + ad_cc, ad_b, ad_tc,
                             ad_cc))
    ops_used = [cell[0]] + [o for nd in cell[1:] for o in (nd[2], nd[3])]
    conv_units = cell_conv_units(cell)
    # per-node launches: node 0 reads its one input (none reads nothing),
    # node i its branches' inputs, each writes once; the collect reads
    # its entries and writes once
    reads = [int(OP_NAMES[cell[0]] != "none")] + [
        sum(OP_NAMES[o] != "none" for o in nd[2:]) for nd in cell[1:]]
    node_units = sum(reads) + len(reads) + len(_collect_inds(cell)) + 1
    pool_hw = list(taps_hw)
    for bi, (i, j) in enumerate(conns):
        bh = max(pool_hw[i][0], pool_hw[j][0])
        bw = max(pool_hw[i][1], pool_hw[j][1])
        pool_hw.append((bh, bw))
        npx = bh * bw
        # the two aggregate 1x1s, each on its unit; the resize moves
        # their bytes (4 units, as in the JAX walk)
        f_agg = 2 * npx * agg * agg / 1e9
        btc = sum(f_agg for u in agg_u[bi] if u == "tc")
        bcc = sum(f_agg for u in agg_u[bi] if u == "cc")
        bf_ = 2 * f_agg
        bb = 4 * npx * agg * bpe / 1e6
        for o, unit in zip(ops_used, conv_units):
            name = OP_NAMES[o]
            if name in ("skip_connect", "none", "global_average_pool"):
                bb += 2 * npx * agg * bpe / 1e6
                continue
            k, _, sep = _CONV_SPECS[name]
            if sep:
                f_dw = 2 * k * k * npx * agg / 1e9        # CUDA cores
                f_pw = 2 * npx * agg * agg / 1e9          # tensor cores
                bf_ += f_dw + f_pw
                bcc += f_dw
                btc += f_pw
            else:
                f = 2 * k * k * npx * agg * agg / 1e9
                bf_ += f
                btc += f if unit == "tc" else 0.0
                bcc += f if unit == "cc" else 0.0
            bb += 2 * npx * agg * bpe / 1e6
        bb_att = (4 + node_units) * npx * agg * bpe / 1e6
        dec_f += bf_
        dec_tc += btc
        dec_cc += bcc
        dec_b += bb
        dec_b_att += bb_att
        if detail:
            blocks.append(_block(f"cell@1/{h // bh}", bf_, bb_att, btc,
                                 bcc))
    # head: the classifier over the collected entries at stride 4
    npx = (h // 4) * (w // 4)
    f = 2 * npx * 2 * agg * num_classes / 1e9
    hd_b = (npx * 2 * agg * bpe + npx * num_classes * bpe) / 1e6
    hd_tc, hd_cc = (f, 0.0) if head_u == "tc" else (0.0, f)
    dec_f += f
    dec_tc += hd_tc
    dec_cc += hd_cc
    dec_b += hd_b
    dec_b_att += hd_b
    if detail:
        blocks.append(_block("clf", f, hd_b, hd_tc, hd_cc))
    segs.append(_segment(f"decoder ({arch}, {agg}ch cells)", dec_f, dec_b,
                         "per-op HBM round trips; attainable bytes: the "
                         "per-node launches'", tc_g=dec_tc, cc_g=dec_cc,
                         attain_mb=dec_b_att))

    # --- tail: upsample + argmax (CUDA cores) ---
    flat = flat_tail_profitable(w // 4)
    nbytes, _, ops = tail_work(h, w, num_classes, flat=flat)
    segs.append(_segment("tail: upsample+argmax", ops / 1e9, nbytes / 1e6,
                         "W-first tail" if flat else "H-first tail",
                         cc_g=ops / 1e9))

    if detail:
        blocks.insert(0, _block("front", segs[0]["gflop"], segs[0]["mb"],
                                0.0, segs[0]["cuda_core_gflop"]))
        blocks.append(_block("tail", segs[-1]["gflop"], segs[-1]["mb"],
                             0.0, segs[-1]["cuda_core_gflop"]))

    total = sum(s["achievable_ms"] for s in segs)
    total_att = sum(s["attain_ms"] for s in segs)
    return {"segments": segs, "total_ms": total,
            "roofline_ips": 1e3 / total,
            "attainable_ms": total_att,
            "attainable_ips": 1e3 / total_att,
            "gflop_total": sum(s["gflop"] for s in segs),
            "blocks": blocks,
            "peak_bf16_tflops": BF16_FLOP_PER_S / 1e12,
            "peak_hbm_gbs": HBM_BYTES_PER_S / 1e9,
            "peak_f32_tflops": F32_FLOP_PER_S / 1e12}
