"""WACV'20 template decoder built from a genotype
(counterpart: segtpu/models/template_decoders.py).

Genotype schema, as in the JAX package:

    template_genotype = [[i, j, agg, op], ...]   # one per block

The pool starts with the 4 adapted encoder taps (1x1 conv-bn-relu to
``agg_size``); block b reads pool entries i and j, aggregates them by
``AGG_OP_NAMES[agg]`` and appends ``OP_NAMES[op]`` of the result:

* psum: a 1x1 conv-bn-relu on each input (``b1``, ``b2``), both
  upsampled to the larger size, added;
* cat: both inputs upsampled to the larger size, concatenated, and a
  1x1 conv-bn-relu from 2 * agg_size channels (``reduce``).

Entries no block consumes are upsampled to the largest size,
concatenated and fed to a 1x1 classifier with bias. Training builds a
per-block auxiliary classifier (``aux=True``): ``blocks.{b}.aux_clf``, a
1x1 with bias on the block's output, drawn from the generator after
every other module. Submodules register in ``template_decoder_init``'s
order: adapt, blocks (b1, b2 or reduce, then op, then aux_clf), clf.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from segtpu_torch.core.bands import global_hw
from segtpu_torch.core.layers import Conv, ConvBN
from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.models.micro_decoders import (AGG_SIZE, GenotypeError,
                                                _decoder_collect_inds)
from segtpu_torch.ops.layer_factory import AGG_OP_NAMES, NUM_OPS, OP_NAMES, Op


def validate_template_genotype(genotype, num_inputs: int = 4) -> None:
    """Raise GenotypeError unless ``genotype`` is a well-formed block list."""
    if not isinstance(genotype, (list, tuple)) or len(genotype) < 1:
        raise GenotypeError(f"template genotype must be a block list: "
                            f"{genotype!r}")
    for b, block in enumerate(genotype):
        if not (isinstance(block, (list, tuple)) and len(block) == 4):
            raise GenotypeError(f"block {b} must be [i,j,agg,op]: {block!r}")
        i, j, agg, op = block
        pool = num_inputs + b
        for x in (i, j):
            if not isinstance(x, int) or not (0 <= x < pool):
                raise GenotypeError(f"block {b}: index {x!r} out of [0,{pool})")
        if not isinstance(agg, int) or not (0 <= agg < len(AGG_OP_NAMES)):
            raise GenotypeError(f"block {b}: agg {agg!r} out of range")
        if not isinstance(op, int) or not (0 <= op < NUM_OPS):
            raise GenotypeError(f"block {b}: op {op!r} out of range")


def template_conns(genotype) -> List[List[int]]:
    return [[b[0], b[1]] for b in genotype]


class TemplateDecoder(nn.Module):
    """taps (4 NCHW encoder features) -> logits [N, K, H/4, W/4]."""

    def __init__(self, genotype, inp_sizes: Sequence[int], num_classes: int,
                 *, agg_size: int = AGG_SIZE, repeats: int = 1,
                 aux: bool = False, aux_cell: bool = False,
                 generator: torch.Generator):
        # template decoders have no private aux cell: ``aux_cell`` is
        # accepted for the families' common signature and ignored, as in
        # the JAX package
        super().__init__()
        validate_template_genotype(genotype, num_inputs=len(inp_sizes))
        self.genotype = genotype
        self.adapt = nn.ModuleList(
            ConvBN(c, agg_size, 1, act="relu", generator=generator)
            for c in inp_sizes)
        blocks = []
        for _, _, agg, op in genotype:
            if AGG_OP_NAMES[agg] == "psum":
                blk = {"b1": ConvBN(agg_size, agg_size, 1, act="relu",
                                    generator=generator),
                       "b2": ConvBN(agg_size, agg_size, 1, act="relu",
                                    generator=generator)}
            else:
                blk = {"reduce": ConvBN(2 * agg_size, agg_size, 1, act="relu",
                                        generator=generator)}
            blk["op"] = Op(OP_NAMES[op], agg_size, repeats=repeats,
                           generator=generator)
            blocks.append(nn.ModuleDict(blk))
        self.blocks = nn.ModuleList(blocks)
        self.collect = _decoder_collect_inds(template_conns(genotype),
                                             len(inp_sizes))
        self.clf = Conv(len(self.collect) * agg_size, num_classes, 1,
                        bias=True, generator=generator)
        if aux:
            for blk in self.blocks:
                blk["aux_clf"] = Conv(agg_size, num_classes, 1, bias=True,
                                      generator=generator)
        self.eval()

    def forward(self, taps, *, align_corners: bool = True,
                with_aux: bool = False):
        """logits, or (logits, aux logits of each block with a head, at
        the block's resolution) with ``with_aux``."""
        pool = [a(t) for a, t in zip(self.adapt, taps)]
        aux = []
        for blk, (i, j, agg, _) in zip(self.blocks, self.genotype):
            x1, x2 = pool[i], pool[j]
            hw = tuple(map(max, global_hw(x1), global_hw(x2)))
            if AGG_OP_NAMES[agg] == "psum":
                y = (resize_bilinear(blk["b1"](x1), hw,
                                     align_corners=align_corners)
                     + resize_bilinear(blk["b2"](x2), hw,
                                       align_corners=align_corners))
            else:
                y = blk["reduce"](torch.cat(
                    [resize_bilinear(x1, hw, align_corners=align_corners),
                     resize_bilinear(x2, hw, align_corners=align_corners)],
                    dim=1))
            y = blk["op"](y)
            pool.append(y)
            if with_aux and "aux_clf" in blk:
                aux.append(blk["aux_clf"](y))
        hws = [global_hw(pool[i]) for i in self.collect]
        h, w = max(hw[0] for hw in hws), max(hw[1] for hw in hws)
        feats = [resize_bilinear(pool[i], (h, w), align_corners=align_corners)
                 for i in self.collect]
        logits = self.clf(torch.cat(feats, dim=1))
        return (logits, aux) if with_aux else logits
