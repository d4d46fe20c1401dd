"""DeepLab-v3's atrous spatial pyramid pooling head (arXiv:1706.05587
section 3.3) over MobileNet-v2 at output stride 16 (arXiv:1801.04381
section 6.3, Table 7's "MNV2*" head with ASPP; the public code is
tensorflow/models research/deeplab over slim's nets/mobilenet). The
JAX package has no counterpart: the plain reference it is held to is
``segtpu_torch/reference/deeplabv3_mnv2.py``.

Head config (the family's "genotype"): ``{"rates": [6, 12, 18],
"channels": 256, "output_stride": 16}`` (``DEEPLABV3``). On the last
tap f [N, 320, H/16, W/16], every branch a conv-BN-ReLU to ``channels``:

    a0 = 1x1(f);  a_r = 3x3 at dilation r (f), zero padding r;
    p  = ReLU(BN(1x1(GAP(f)))), bilinearly broadcast over the map;
    y  = ReLU(BN(1x1(concat[a0, a_r..., p])));  logits = 1x1 + bias (y)

No dropout at inference. Parameters: ``branches.{0..}`` (0 the 1x1, then
one per rate), ``pool``, ``project``, ``clf`` (a ``Conv`` with bias).

``FoldedASPPDecoder`` is the engine's form: BatchNorm folded, the 1x1
branch and the atrous branches in one ``kernels.aspp.aspp_chw`` launch
(tensor cores) into their concatenation, the pooled branch as a
per-image vector (its slice of the projection times p, in f32: the same
sum, since p is constant over the map) that the projection's launch
adds before its ReLU, and the classifier on ``conv_chw``'s 1x1 route.
Dense weights in the compute dtype, packed once for the tensor cores;
the pooled branch, its slice of the projection and every bias f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from segtpu_torch.core.bands import global_hw
from segtpu_torch.core.layers import Conv, ConvBN
from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.kernels.aspp import aspp_chw
from segtpu_torch.kernels.chw_ops import conv_chw, pack_weights
from segtpu_torch.models.fast_encoder import _fold
from segtpu_torch.models.micro_decoders import GenotypeError
from segtpu_torch.utils.profiling import span

DEEPLABV3 = {"rates": [6, 12, 18], "channels": 256, "output_stride": 16}


def is_aspp_head(genotype) -> bool:
    """A head config (a dict with ``rates``), not a NAS genotype."""
    return isinstance(genotype, dict) and "rates" in genotype


def validate_aspp_head(head, num_inputs: int = 4) -> None:
    """Raise GenotypeError unless ``head`` is a well-formed head config:
    ``rates`` a non-empty list of at most three positive ints (the
    kernel's launch holds the 1x1 and three atrous branches),
    ``channels`` a positive multiple of 8, ``output_stride`` 16 or 32."""
    if not is_aspp_head(head):
        raise GenotypeError(f"an ASPP head is a dict with rates, channels "
                            f"and output_stride: {head!r}")
    extra = set(head) - {"rates", "channels", "output_stride"}
    if extra:
        raise GenotypeError(f"unknown ASPP head keys {sorted(extra)}")
    rates = head["rates"]
    if (not isinstance(rates, (list, tuple)) or not 1 <= len(rates) <= 3
            or not all(isinstance(r, int) and r >= 1 for r in rates)):
        raise GenotypeError(f"rates must be 1 to 3 positive ints: {rates!r}")
    ch = head.get("channels")
    if not isinstance(ch, int) or ch < 8 or ch % 8:
        raise GenotypeError(f"channels must be a positive multiple of 8: "
                            f"{ch!r}")
    if head.get("output_stride") not in (16, 32):
        raise GenotypeError(f"output_stride is 16 or 32: "
                            f"{head.get('output_stride')!r}")
    if num_inputs < 1:
        raise GenotypeError("the ASPP head reads the last encoder tap")


def encoder_stride(head) -> int:
    return int(head["output_stride"])


class ASPPDecoder(nn.Module):
    """taps (4 NCHW encoder features) -> logits [N, K, H/os, W/os], from
    the last tap alone. Built with the families' common signature
    (``agg_size``, ``repeats`` and ``aux_cell`` are the NAS decoders' and
    are ignored); it has no auxiliary heads, so ``aux`` raises."""

    def __init__(self, head, inp_sizes: Sequence[int], num_classes: int, *,
                 agg_size: int = 0, repeats: int = 1, aux: bool = False,
                 aux_cell: bool = False, generator: torch.Generator):
        super().__init__()
        validate_aspp_head(head, len(inp_sizes))
        if aux:
            raise TypeError("the deeplab family has no auxiliary heads: it "
                            "is served, not trained, by this package")
        self.genotype = head
        cin, ch = inp_sizes[-1], head["channels"]
        self.rates = list(head["rates"])
        self.branches = nn.ModuleList(
            [ConvBN(cin, ch, 1, act="relu", generator=generator)]
            + [ConvBN(cin, ch, 3, dilation=r, act="relu", generator=generator)
               for r in self.rates])
        self.pool = ConvBN(cin, ch, 1, act="relu", generator=generator)
        self.project = ConvBN(ch * (len(self.rates) + 2), ch, 1, act="relu",
                              generator=generator)
        self.clf = Conv(ch, num_classes, 1, bias=True, generator=generator)
        self.eval()

    def forward(self, taps, *, align_corners: bool = True,
                with_aux: bool = False):
        """logits, or (logits, []) with ``with_aux``."""
        f = taps[-1]
        outs = [br(f) for br in self.branches]
        p = self.pool(f.mean((2, 3), keepdim=True))
        outs.append(resize_bilinear(p, global_hw(f),
                                    align_corners=align_corners))
        logits = self.clf(self.project(torch.cat(outs, dim=1)))
        return (logits, []) if with_aux else logits


def _packed(w, compute_dtype):
    return pack_weights(w) if compute_dtype == torch.bfloat16 else None


class FoldedASPPDecoder(nn.Module):
    """Four NCHW encoder taps -> logits, the head with BatchNorm folded
    (see the module doc). Buffers: each branch's ``w{i}``, ``b{i}`` and
    packed ``wp{i}``; the pooled branch's ``pool_w`` [C, Cin] and
    ``pool_b``; the projection's ``proj_w`` (its concatenated branches'
    input channels, compute dtype), ``proj_wp``, ``proj_pool_w`` [C, C]
    (its pooled slice, f32) and ``proj_b``; ``clf_w``, ``clf_b``."""

    def __init__(self, dec: ASPPDecoder, compute_dtype):
        super().__init__()
        self.genotype = dec.genotype
        self.dilations = [1] + dec.rates
        for i, br in enumerate(dec.branches):
            w, b = _fold(br)
            self.register_buffer(f"w{i}", w.to(compute_dtype))
            self.register_buffer(f"b{i}", b)
            self.register_buffer(f"wp{i}", _packed(w, compute_dtype),
                                 persistent=False)
        w, b = _fold(dec.pool)
        self.register_buffer("pool_w", w[:, :, 0, 0].contiguous())
        self.register_buffer("pool_b", b)
        w, b = _fold(dec.project)
        ncat = w.shape[0] * len(self.dilations)
        main = w[:, :ncat].contiguous()
        self.register_buffer("proj_w", main.to(compute_dtype))
        self.register_buffer("proj_wp", _packed(main, compute_dtype),
                             persistent=False)
        self.register_buffer("proj_pool_w", w[:, ncat:, 0, 0].contiguous())
        self.register_buffer("proj_b", b)
        if dec.clf.w.dtype != torch.float32:
            raise ValueError("fold_decoder folds f32 weights: fold before "
                             "casting")
        self.register_buffer("clf_w", dec.clf.w.detach().to(compute_dtype))
        self.register_buffer("clf_b", dec.clf.b.detach().float())

    def branch_weights(self):
        n = len(self.dilations)
        return ([getattr(self, f"w{i}") for i in range(n)],
                [getattr(self, f"b{i}") for i in range(n)],
                [getattr(self, f"wp{i}") for i in range(n)])

    def vector(self, f):
        """The pooled branch's share of the projection, [B, C] f32:
        proj_pool_w . relu(pool_w . mean(f) + pool_b), an image at a time
        (``fast_decoder.per_image``'s rule: the same bits at any batch)."""
        pooled = torch.cat([torch.mean(f[i:i + 1], (2, 3),
                                       dtype=torch.float32)
                            for i in range(f.shape[0])])
        p = torch.relu((pooled[:, None, :] * self.pool_w).sum(-1)
                       + self.pool_b)
        return (p[:, None, :] * self.proj_pool_w).sum(-1)

    def forward(self, taps, *, align_corners: bool = True,
                use_kernels: bool = True):
        uk, f = use_kernels, taps[-1]
        ws, bs, wps = self.branch_weights()
        with span("segtpu.engine.decoder.aspp", device=f.device):
            cat = aspp_chw(f, ws, bs, self.dilations,
                           packed=None if wps[0] is None else wps,
                           use_kernels=uk)
            y = aspp_chw(cat, [self.proj_w], [self.proj_b], [1],
                         self.vector(f),
                         packed=None if self.proj_wp is None
                         else [self.proj_wp], use_kernels=uk)
            return conv_chw(y, self.clf_w, self.clf_b, k=1, act="none",
                            use_kernels=uk)
