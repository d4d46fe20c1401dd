"""NAS micro-decoder built from a genotype
(counterpart: segtpu/models/micro_decoders.py).

Genotype schema, as in the JAX package:

    genotype = [cell_config, conns]
    cell_config = [op0, [p1, p2, o1, o2], ...]   # node 0 + paired nodes
    conns = [[i, j], ...]                        # one pair per block

The pool starts with the 4 adapted encoder taps; block b merges pool
entries i and j (aggregate cell), runs the contextual cell and appends
the result. Entries no block consumes are upsampled to the largest
size, concatenated and fed to a 1x1 classifier with bias (logits at
1/4 input resolution). Submodules register in ``micro_decoder_init``'s
order: adapt, blocks (agg, cell, aux), clf.

Training builds per-block auxiliary heads (``aux=True``): block b's
``blocks.{b}.aux.clf``, a 1x1 classifier with bias on the block's output,
after a private contextual cell ``blocks.{b}.aux.cell`` with
``aux_cell=True`` — the JAX pytree's paths, so ``load_jax_params`` maps
them by name. They draw from the generator after every other module, so
a decoder with heads holds the same other weights as one without.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from segtpu_torch.core.layers import Conv, ConvBN
from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.ops.layer_factory import NUM_OPS, OP_NAMES, Op

AGG_SIZE = 48  # reference default agg_size


class GenotypeError(ValueError):
    """Invalid sampled architecture."""


def validate_genotype(genotype, num_inputs: int = 4) -> None:
    """Raise GenotypeError unless ``genotype`` is well-formed."""
    try:
        cell_config, conns = genotype
    except (TypeError, ValueError):
        raise GenotypeError(f"genotype must be [cell_config, conns]: {genotype!r}")
    if not isinstance(cell_config, (list, tuple)) or len(cell_config) < 1:
        raise GenotypeError(f"bad cell_config: {cell_config!r}")
    op0 = cell_config[0]
    if not isinstance(op0, int) or not (0 <= op0 < NUM_OPS):
        raise GenotypeError(f"bad first cell op: {op0!r}")
    for k, node in enumerate(cell_config[1:], start=1):
        if not (isinstance(node, (list, tuple)) and len(node) == 4):
            raise GenotypeError(f"cell node {k} must be [p1,p2,o1,o2]: {node!r}")
        p1, p2, o1, o2 = node
        n_pos = k + 1  # [x, node0..node_{k-1}]
        for p in (p1, p2):
            if not isinstance(p, int) or not (0 <= p < n_pos):
                raise GenotypeError(f"cell node {k}: position {p!r} out of [0,{n_pos})")
        for o in (o1, o2):
            if not isinstance(o, int) or not (0 <= o < NUM_OPS):
                raise GenotypeError(f"cell node {k}: op {o!r} out of range")
    if not isinstance(conns, (list, tuple)) or len(conns) < 1:
        raise GenotypeError(f"bad conns: {conns!r}")
    for b, conn in enumerate(conns):
        if not (isinstance(conn, (list, tuple)) and len(conn) == 2):
            raise GenotypeError(f"block {b} conn must be [i,j]: {conn!r}")
        pool = num_inputs + b
        for i in conn:
            if not isinstance(i, int) or not (0 <= i < pool):
                raise GenotypeError(f"block {b}: pool index {i!r} out of [0,{pool})")


def prettify(genotype) -> str:
    """A micro genotype in words, a line for each cell node and for each
    block (reference: MicroDecoder.prettify); the JAX package's string."""
    cell_config, conns = genotype
    op0 = OP_NAMES[cell_config[0]]
    names = ["x", f"{op0}(x)"]
    lines = [f"cell: node0 = {op0}(x)"]
    for k, (p1, p2, o1, o2) in enumerate(cell_config[1:], start=1):
        lines.append(f"      node{k} = {OP_NAMES[o1]}({names[p1]}) + "
                     f"{OP_NAMES[o2]}({names[p2]})")
        names.append(f"n{k}")
    lines += [f"block{b}: merge(pool[{i}], pool[{j}]) -> cell"
              for b, (i, j) in enumerate(conns)]
    return "\n".join(lines)


def _cell_collect_inds(cell_config) -> List[int]:
    """Node outputs (incl. x at index 0) never consumed by a later node."""
    n_outputs = len(cell_config) + 1
    used = {0}  # x is consumed by node 0
    for p1, p2, _, _ in cell_config[1:]:
        used.add(p1)
        used.add(p2)
    return [i for i in range(n_outputs) if i not in used]


def _decoder_collect_inds(conns, num_inputs: int) -> List[int]:
    used = set()
    for i, j in conns:
        used.add(i)
        used.add(j)
    n_pool = num_inputs + len(conns)
    return [i for i in range(n_pool) if i not in used]


class Cell(nn.Module):
    """Contextual cell: node0 = op0(x); node k = a(outs[p1]) + b(outs[p2]);
    output = left-to-right sum of the uncollected node outputs."""

    def __init__(self, cell_config, c: int, *, repeats: int = 1,
                 generator: torch.Generator):
        super().__init__()
        self.cell_config = cell_config
        self.node0 = Op(OP_NAMES[cell_config[0]], c, repeats=repeats,
                        generator=generator)
        self.nodes = nn.ModuleList(
            nn.ModuleDict({
                "a": Op(OP_NAMES[o1], c, repeats=repeats, generator=generator),
                "b": Op(OP_NAMES[o2], c, repeats=repeats, generator=generator)})
            for _, _, o1, o2 in cell_config[1:])
        self.collect = _cell_collect_inds(cell_config)

    def forward(self, x):
        outs = [x, self.node0(x)]
        for k, (p1, p2, _, _) in enumerate(self.cell_config[1:]):
            node = self.nodes[k]
            outs.append(node["a"](outs[p1]) + node["b"](outs[p2]))
        out = None
        for i in self.collect:
            out = outs[i] if out is None else out + outs[i]
        return out


class Agg(nn.Module):
    """Aggregate cell: 1x1 conv-bn-relu on both inputs, upsample the
    smaller to the larger size, add."""

    def __init__(self, c1: int, c2: int, agg_size: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.branch1 = ConvBN(c1, agg_size, 1, act="relu", generator=generator)
        self.branch2 = ConvBN(c2, agg_size, 1, act="relu", generator=generator)

    def forward(self, x1, x2, *, align_corners: bool = True):
        y1, y2 = self.branch1(x1), self.branch2(x2)
        hw = (max(y1.shape[-2], y2.shape[-2]), max(y1.shape[-1], y2.shape[-1]))
        return (resize_bilinear(y1, hw, align_corners=align_corners)
                + resize_bilinear(y2, hw, align_corners=align_corners))


class MicroDecoder(nn.Module):
    """taps (4 NCHW encoder features) -> logits [N, K, H/4, W/4]."""

    def __init__(self, genotype, inp_sizes: Sequence[int], num_classes: int,
                 *, agg_size: int = AGG_SIZE, repeats: int = 1,
                 aux: bool = False, aux_cell: bool = False,
                 generator: torch.Generator):
        super().__init__()
        validate_genotype(genotype, num_inputs=len(inp_sizes))
        cell_config, conns = genotype
        self.genotype = genotype
        self.adapt = nn.ModuleList(
            ConvBN(c, agg_size, 1, act="relu", generator=generator)
            for c in inp_sizes)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({
                "agg": Agg(agg_size, agg_size, agg_size, generator=generator),
                "cell": Cell(cell_config, agg_size, repeats=repeats,
                             generator=generator)})
            for _ in conns)
        self.collect = _decoder_collect_inds(conns, len(inp_sizes))
        self.clf = Conv(len(self.collect) * agg_size, num_classes, 1,
                        bias=True, generator=generator)
        if aux:
            for blk in self.blocks:
                head = {}
                if aux_cell:
                    head["cell"] = Cell(cell_config, agg_size,
                                        repeats=repeats, generator=generator)
                head["clf"] = Conv(agg_size, num_classes, 1, bias=True,
                                   generator=generator)
                blk["aux"] = nn.ModuleDict(head)
        self.eval()

    def forward(self, taps, *, align_corners: bool = True,
                with_aux: bool = False):
        """logits, or (logits, aux logits of each block with a head, at
        the block's resolution) with ``with_aux``."""
        _, conns = self.genotype
        pool = [a(t) for a, t in zip(self.adapt, taps)]
        aux = []
        for b, (i, j) in enumerate(conns):
            blk = self.blocks[b]
            y = blk["agg"](pool[i], pool[j], align_corners=align_corners)
            y = blk["cell"](y)
            pool.append(y)
            if with_aux and "aux" in blk:
                head = blk["aux"]
                aux.append(head["clf"](head["cell"](y) if "cell" in head
                                       else y))
        h = max(pool[i].shape[-2] for i in self.collect)
        w = max(pool[i].shape[-1] for i in self.collect)
        feats = [resize_bilinear(pool[i], (h, w), align_corners=align_corners)
                 for i in self.collect]
        logits = self.clf(torch.cat(feats, dim=1))
        return (logits, aux) if with_aux else logits
