"""The micro and template decoders with BatchNorm folded, every op a
fused kernel (counterpart: segtpu/models/fast_decoder.py::
build_fast_decoder, the single-device path, and
build_fast_template_decoder).

``fold_decoder(dec, compute_dtype)`` folds eval BatchNorm into the conv
weights of a ``MicroDecoder`` or a ``TemplateDecoder`` from its f32
weights and returns a ``FoldedMicroDecoder`` or a
``FoldedTemplateDecoder``, whose forward takes the four NCHW encoder
taps and returns the logits [N, K, H/4, W/4]. The micro decoder has the
JAX fast decoder's structure:

* a tap used by one aggregate branch only keeps its 1x1 adapt pending
  and runs it with that branch's 1x1 as one ``pw_chain_chw`` (or inside
  the resize kernel, when it is the branch that is not resized);
* the aggregate cell's pair add rides in the second resize
  (``resize_chw`` with ``acc``);
* each cell runs its nodes up to the last one a global-average-pool
  branch reads through the per-node kernels (``sep_conv_chw``,
  ``conv_chw``, ``pair_op_chw``, a pool vector riding in as
  ``vec_acc``), and the rest as one ``cell_op_chw``;
* the head is ``conv_chw`` (k=1) or, over several collected entries,
  ``pw_multi_chw`` without their concatenation.

The template decoder keeps ``build_fast_template_decoder``'s steps,
whose bf16 roundings its bits depend on: every adapt and aggregation
1x1 is its own ``conv_chw`` (k=1); psum is
``resize(pw(x2, b2), acc=resize(pw(x1, b1)))``, where a branch already
at the block's size is not resized and its add is a plain one; cat
resizes both inputs, concatenates them and runs the reduce 1x1; the
block op and the head are the micro decoder's (``FoldedOp``,
``_FoldedHead``).

Dense weights are rounded to the compute dtype after folding in f32;
depthwise weights, the pool's 1x1 and all biases stay f32.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from segtpu_torch.kernels.chw_ops import (cell_op_chw, conv_chw,
                                          pack_weights, pair_op_chw,
                                          pw_chain_chw, pw_multi_chw,
                                          sep_conv_chw)
from segtpu_torch.kernels.resize_chw import resize_chw, shard_interp_bands
from segtpu_torch.models.fast_encoder import _fold, crop_h
from segtpu_torch.models.micro_decoders import (MicroDecoder,
                                                _cell_collect_inds)
from segtpu_torch.models.template_decoders import TemplateDecoder
from segtpu_torch.ops.layer_factory import AGG_OP_NAMES, _CONV_SPECS, OP_NAMES
from segtpu_torch.parallel.collectives import (gather_h, halo_exchange,
                                               per_device, sum_shards)


def per_image(reduce, x):
    """``reduce`` (``torch.mean`` or ``torch.sum``) of x [B, C, H, W] over
    H and W in f32, one image at a time: [B, C]. A library reduction may
    choose its sum order by the tensor's size; image by image every
    frame's result has the same bits at any batch size, so a batch cut
    into parts (``parallel`` mode "data") gives the unsharded bits."""
    return torch.cat([reduce(x[i:i + 1], (2, 3), dtype=torch.float32)
                      for i in range(x.shape[0])])


def _tc_packed(w, compute_dtype):
    """The bf16 tensor-core kernels' operand of the OIHW weight w, packed
    once here (``pack_weights``); None in f32, whose kernels read OIHW."""
    return pack_weights(w) if compute_dtype == torch.bfloat16 else None


class FoldedOp(nn.Module):
    """One cell op with BN folded: kind "skip", "none", "gap", "conv" or
    "sep" (its repeats as buffers ``dw{r}``/``bdw{r}``/``pw{r}``/
    ``bpw{r}``, and ``pwp{r}``, the 1x1 weight packed for the bf16
    kernels; a conv's as ``w``, ``b`` and ``wp``)."""

    def __init__(self, op, compute_dtype):
        super().__init__()
        name = op.name
        self.halo = 0        # rows the op's taps reach beyond its own row
        if name in ("skip_connect", "none"):
            self.kind = "skip" if name == "skip_connect" else "none"
            return
        if name == "global_average_pool":
            self.kind = "gap"
            w, b = _fold(op.conv)
            self.register_buffer("w", w[:, :, 0, 0].contiguous())   # f32
            self.register_buffer("b", b)
            return
        self.k, self.dil, sep = _CONV_SPECS[name]
        self.halo = self.dil * (self.k // 2)
        if sep:
            self.kind = "sep"
            self.n_reps = len(op.reps)
            for r, rep in enumerate(op.reps):
                wd, bd = _fold(rep["dw"])
                wp, bp = _fold(rep["pw"])
                self.register_buffer(f"dw{r}", wd)
                self.register_buffer(f"bdw{r}", bd)
                self.register_buffer(f"pw{r}", wp.to(compute_dtype))
                self.register_buffer(f"bpw{r}", bp)
                self.register_buffer(f"pwp{r}", _tc_packed(wp, compute_dtype))
        else:
            self.kind = "conv"
            w, b = _fold(op.conv)
            self.register_buffer("w", w.to(compute_dtype))
            self.register_buffer("b", b)
            self.register_buffer("wp", _tc_packed(w, compute_dtype))

    def rep(self, r: int):
        return (getattr(self, f"dw{r}"), getattr(self, f"bdw{r}"),
                getattr(self, f"pw{r}"), getattr(self, f"bpw{r}"))

    def packed(self, r: int = 0):
        """Repeat r's packed 1x1 weight (sep), or the packed dense weight
        (conv); None in f32."""
        return getattr(self, f"pwp{r}") if self.kind == "sep" else self.wp

    def vector(self, x):
        """The pool op's [B, C] f32 result, relu(mean(x) @ w + b), without
        its spatial broadcast."""
        return self.vector_of_mean(per_image(torch.mean, x))

    def vector_of_mean(self, pooled):
        """The pool op's vector from the [B, C] f32 means of its input."""
        # an elementwise product and row sums, not a matrix product: each
        # image's vector then has the same bits at any batch size
        return torch.relu((pooled[:, None, :] * self.w).sum(-1) + self.b)

    def forward(self, x, acc=None, vec_acc=None, use_kernels: bool = True):
        if self.kind == "none":
            return torch.zeros_like(x) if acc is None else acc
        if self.kind == "skip":
            return x if acc is None else x + acc
        if self.kind == "gap":
            y = self.vector(x).to(x.dtype)[:, :, None, None].expand(
                -1, -1, *x.shape[2:])
            return y.contiguous() if acc is None else y + acc
        if self.kind == "sep":
            for r in range(self.n_reps):
                last = r == self.n_reps - 1
                x = sep_conv_chw(x, *self.rep(r), acc if last else None,
                                 vec_acc if last else None, k=self.k,
                                 dilation=self.dil, packed=self.packed(r),
                                 use_kernels=use_kernels)
            return x
        return conv_chw(x, self.w, self.b, acc, vec_acc, k=self.k,
                        dilation=self.dil, use_kernels=use_kernels)

    def fuse_spec(self):
        """(op, weights, packed weight) of this op's last kernel for
        ``pair_op_chw``, or None (gap, skip, none)."""
        if self.kind == "conv":
            return ("conv", self.k, self.dil), (self.w, self.b), self.wp
        if self.kind == "sep":
            r = self.n_reps - 1
            return ("sep", self.k, self.dil), self.rep(r), self.packed(r)
        return None

    def prefix(self, x, use_kernels: bool):
        """Every kernel of the op but the last (sep repeats > 1)."""
        if self.kind == "sep":
            for r in range(self.n_reps - 1):
                x = sep_conv_chw(x, *self.rep(r), k=self.k,
                                 dilation=self.dil, packed=self.packed(r),
                                 use_kernels=use_kernels)
        return x

    def branch(self, entry: int):
        """This op as a ``cell_op_chw`` branch reading ``entry`` (single
        repeat; gap vectors are added by the caller)."""
        if self.kind == "conv":
            return {"kind": "conv", "entry": entry, "k": self.k,
                    "dil": self.dil, "w": self.w, "b": self.b,
                    "wp": self.wp}
        if self.kind == "sep":
            wdw, bdw, wpw, bpw = self.rep(0)
            return {"kind": "sep", "entry": entry, "k": self.k,
                    "dil": self.dil, "wdw": wdw, "bdw": bdw, "wpw": wpw,
                    "bpw": bpw, "wp": self.packed(0)}
        if self.kind == "skip":
            return {"kind": "skip", "entry": entry}
        return {"kind": "none"}


class _LazyTap:
    """A tap whose 1x1 adapt (a ``_Folded1x1``) is deferred into its one
    consumer's kernel: ``adapt`` its (w, b), ``packed`` its packed weight;
    ``shape`` is the adapted shape."""

    def __init__(self, x, adapt):
        self.x, self.adapt, self.packed = x, adapt.wb(), adapt.wp
        self.shape = (x.shape[0], adapt.w.shape[0], *x.shape[2:])


def _node_pair(opa, xa, opb, xb, uk: bool):
    """One cell node, opb(xb) + opa(xa), in the fewest kernels: both
    branches in ``pair_op_chw`` when both end in a conv, a pool branch
    as the partner's ``vec_acc``, else opa's output as opb's ``acc``."""
    fa, fb = opa.fuse_spec(), opb.fuse_spec()
    if fa is not None and fb is not None:
        return pair_op_chw(opb.prefix(xb, uk), fb[1], opa.prefix(xa, uk),
                           fa[1], op1=fb[0], op2=fa[0], packed=(fb[2], fa[2]),
                           use_kernels=uk)
    if opa.kind == "gap" and fb is not None:
        return opb(xb, vec_acc=opa.vector(xa), use_kernels=uk)
    if opb.kind == "gap" and fa is not None:
        return opa(xa, vec_acc=opb.vector(xb), use_kernels=uk)
    return opb(xb, acc=opa(xa, use_kernels=uk), use_kernels=uk)


def _resize(x, hw, ac: bool, uk: bool, acc=None, acc_chain=None):
    """x resized to hw (+ acc, or + the 1x1 chain of ``acc_chain`` =
    (raw, stages, the stages' packed weights)); x already at hw is not
    resized, and its add is a plain one."""
    if tuple(x.shape[2:]) == hw:
        if acc_chain is not None:
            raw, stages, packed = acc_chain
            acc = pw_chain_chw(raw, stages, packed=packed, use_kernels=uk)
        return x if acc is None else x + acc
    return resize_chw(x, hw, acc, None if acc_chain is None
                      else acc_chain[:2], align_corners=ac, use_kernels=uk)


class _FoldedHead(nn.Module):
    """The classifier of a folded decoder: the 1x1 weight in the compute
    dtype (``clf_w``, packed for the bf16 kernels as ``clf_wp``) and its
    f32 bias (``clf_b``)."""

    def _register_head(self, clf, compute_dtype):
        if clf.w.dtype != torch.float32:
            raise ValueError("fold_decoder folds f32 weights: fold before "
                             "casting")
        self.register_buffer("clf_w", clf.w.detach().to(compute_dtype))
        self.register_buffer("clf_wp", _tc_packed(clf.w.detach(),
                                                  compute_dtype))
        self.register_buffer("clf_b", clf.b.detach().float())

    def _head(self, srcs, uk: bool):
        """The classifier over the collected entries, without their
        concatenation."""
        if len(srcs) == 1:
            return conv_chw(srcs[0], self.clf_w, self.clf_b, k=1, act="none",
                            use_kernels=uk)
        ws, off = [], 0
        for s in srcs:
            ws.append(self.clf_w[:, off:off + s.shape[1]])
            off += s.shape[1]
        return pw_multi_chw(srcs, ws, self.clf_b, act="none",
                            packed=self.clf_wp, use_kernels=uk)


class FoldedMicroDecoder(_FoldedHead):
    """Four NCHW encoder taps -> logits [N, K, H/4, W/4]."""

    def __init__(self, dec: MicroDecoder, compute_dtype):
        super().__init__()
        cell_config, conns = dec.genotype
        self.cell_config, self.conns = cell_config, conns
        self.adapt = nn.ModuleList(_Folded1x1(a, compute_dtype)
                                   for a in dec.adapt)
        self.agg1 = nn.ModuleList(_Folded1x1(blk["agg"].branch1, compute_dtype)
                                  for blk in dec.blocks)
        self.agg2 = nn.ModuleList(_Folded1x1(blk["agg"].branch2, compute_dtype)
                                  for blk in dec.blocks)
        self.node0 = nn.ModuleList(FoldedOp(blk["cell"].node0, compute_dtype)
                                   for blk in dec.blocks)
        self.nodes = nn.ModuleList(
            nn.ModuleList(nn.ModuleList([FoldedOp(nd["a"], compute_dtype),
                                         FoldedOp(nd["b"], compute_dtype)])
                          for nd in blk["cell"].nodes)
            for blk in dec.blocks)
        self._register_head(dec.clf, compute_dtype)
        self.collect = list(dec.collect)
        self.cell_collect = _cell_collect_inds(cell_config)
        n_taps = len(dec.adapt)
        uses = [sum(idx == i for c in conns for idx in c)
                + (i in self.collect) for i in range(n_taps)]
        # a tap read once, by an aggregate branch, defers its adapt
        self.lazy = [uses[i] == 1 and i not in self.collect
                     for i in range(n_taps)]

    def _cell_plan(self, bi: int):
        """(the node DAG as [(op, src), ...] per node, the first node
        ``cell_op_chw`` runs), or None when no suffix can fuse: nodes up
        to the last entry a pool branch reads must exist whole first, and
        a fused sep op has one repeat."""
        all_nodes = [[(self.node0[bi], 0)]]
        for (opa, opb), (p1, p2, _, _) in zip(self.nodes[bi],
                                              self.cell_config[1:]):
            all_nodes.append([(opa, p1), (opb, p2)])
        start = max([src for branches in all_nodes for op, src in branches
                     if op.kind == "gap"], default=0)
        if start >= len(all_nodes):
            return None
        if any(op.kind == "sep" and op.n_reps != 1
               for branches in all_nodes[start:] for op, _ in branches):
            return None
        return all_nodes, start

    def _cell(self, bi: int, y, uk: bool):
        plan = self._cell_plan(bi)
        if plan is None:
            outs = [y, self.node0[bi](y, use_kernels=uk)]
            for (opa, opb), (p1, p2, _, _) in zip(self.nodes[bi],
                                                  self.cell_config[1:]):
                outs.append(_node_pair(opa, outs[p1], opb, outs[p2], uk))
            acc = None
            for ci in self.cell_collect:
                acc = outs[ci] if acc is None else acc + outs[ci]
            return acc
        all_nodes, start = plan
        outs = [y]
        if start >= 1:
            outs.append(self.node0[bi](y, use_kernels=uk))
        for i in range(1, start):
            (opa, p1), (opb, p2) = all_nodes[i]
            outs.append(_node_pair(opa, outs[p1], opb, outs[p2], uk))
        nodes_desc = []
        for branches in all_nodes[start:]:
            nodes_desc.append([
                {"kind": "vec", "vec": op.vector(outs[src])}
                if op.kind == "gap" else op.branch(src)
                for op, src in branches])
        return cell_op_chw(outs, nodes_desc, self.cell_collect,
                           use_kernels=uk)

    def forward(self, taps, *, align_corners: bool = True,
                use_kernels: bool = True):
        uk, ac = use_kernels, align_corners

        def agg_pw(entry, mod):
            return self._agg_pw(entry, mod, uk)

        pool: List = []
        for lazy, t, a in zip(self.lazy, taps, self.adapt):
            pool.append(_LazyTap(t, a) if lazy
                        else conv_chw(t, *a.wb(), k=1, use_kernels=uk))
        for bi, (i, j) in enumerate(self.conns):
            br = [(pool[i], self.agg1[bi]), (pool[j], self.agg2[bi])]
            shp = [tuple(e.shape) for e, _ in br]
            hw = (max(s[2] for s in shp), max(s[3] for s in shp))
            # resize the branch that needs it last, so that the other
            # rides in as its acc
            if shp[1][2:] == hw and shp[0][2:] != hw:
                br.reverse()
                shp.reverse()
            (e1, m1), (e2, m2) = br
            if isinstance(e1, _LazyTap) and shp[0][2:] == hw:
                y = _resize(agg_pw(e2, m2), hw, ac, uk,
                            acc_chain=(e1.x, [e1.adapt, m1.wb()],
                                       [e1.packed, m1.wp]))
            else:
                y = _resize(agg_pw(e2, m2), hw, ac, uk,
                            acc=_resize(agg_pw(e1, m1), hw, ac, uk))
            pool.append(self._cell(bi, y, uk))
        hw = (max(pool[i].shape[2] for i in self.collect),
              max(pool[i].shape[3] for i in self.collect))
        return self._head([_resize(pool[i], hw, ac, uk)
                           for i in self.collect], uk)

    def _agg_pw(self, entry, mod, uk: bool):
        """An aggregate branch's 1x1 on a pool entry; a lazy tap's
        pending adapt runs in the same kernel."""
        if isinstance(entry, _LazyTap):
            return pw_chain_chw(entry.x, [entry.adapt, mod.wb()],
                                packed=[entry.packed, mod.wp], use_kernels=uk)
        return conv_chw(entry, *mod.wb(), k=1, use_kernels=uk)


class _Folded1x1(nn.Module):
    """A 1x1 conv-bn-relu with BN folded (dense weight in the compute
    dtype, f32 bias)."""

    def __init__(self, conv_bn, compute_dtype):
        super().__init__()
        w, b = _fold(conv_bn)
        self.register_buffer("w", w.to(compute_dtype))
        self.register_buffer("b", b)
        self.register_buffer("wp", _tc_packed(w, compute_dtype))

    def wb(self):
        return self.w, self.b


class FoldedTemplateDecoder(_FoldedHead):
    """Four NCHW encoder taps -> logits [N, K, H/4, W/4], the template
    decoder's steps as ``build_fast_template_decoder`` takes them."""

    def __init__(self, dec: TemplateDecoder, compute_dtype):
        super().__init__()
        self.genotype = dec.genotype
        self.aggs = [AGG_OP_NAMES[agg] for _, _, agg, _ in dec.genotype]
        self.adapt = nn.ModuleList(_Folded1x1(a, compute_dtype)
                                   for a in dec.adapt)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({name: (FoldedOp if name == "op" else _Folded1x1)(
                mod, compute_dtype) for name, mod in blk.items()
                if name != "aux_clf"})      # training's heads: not served
            for blk in dec.blocks)
        self._register_head(dec.clf, compute_dtype)
        self.collect = list(dec.collect)

    def forward(self, taps, *, align_corners: bool = True,
                use_kernels: bool = True):
        uk, ac = use_kernels, align_corners

        def pw(x, mod):
            return conv_chw(x, *mod.wb(), k=1, use_kernels=uk)

        pool = [pw(t, a) for t, a in zip(taps, self.adapt)]
        for blk, agg, (i, j, _, _) in zip(self.blocks, self.aggs,
                                          self.genotype):
            x1, x2 = pool[i], pool[j]
            hw = (max(x1.shape[2], x2.shape[2]),
                  max(x1.shape[3], x2.shape[3]))
            if agg == "psum":
                y = _resize(pw(x2, blk["b2"]), hw, ac, uk,
                            acc=_resize(pw(x1, blk["b1"]), hw, ac, uk))
            else:
                y = pw(torch.cat([_resize(x1, hw, ac, uk),
                                  _resize(x2, hw, ac, uk)], dim=1),
                       blk["reduce"])
            pool.append(blk["op"](y, use_kernels=uk))
        hw = (max(pool[i].shape[2] for i in self.collect),
              max(pool[i].shape[3] for i in self.collect))
        return self._head([_resize(pool[i], hw, ac, uk)
                           for i in self.collect], uk)


def fold_decoder(dec, compute_dtype=torch.bfloat16):
    """The folded decoder of ``dec``'s f32 weights, on dec's device: a
    ``FoldedMicroDecoder`` of a ``MicroDecoder``, a
    ``FoldedTemplateDecoder`` of a ``TemplateDecoder``, a
    ``FoldedASPPDecoder`` of an ``ASPPDecoder`` (the deeplab family)."""
    # aspp_decoder reads fast_encoder, which this module's importers load
    from segtpu_torch.models.aspp_decoder import (ASPPDecoder,
                                                  FoldedASPPDecoder)
    if isinstance(dec, MicroDecoder):
        return FoldedMicroDecoder(dec, compute_dtype).eval()
    if isinstance(dec, TemplateDecoder):
        return FoldedTemplateDecoder(dec, compute_dtype).eval()
    if isinstance(dec, ASPPDecoder):
        return FoldedASPPDecoder(dec, compute_dtype).eval()
    raise TypeError(f"fold_decoder takes a MicroDecoder, a TemplateDecoder "
                    f"or an ASPPDecoder, not {type(dec).__name__}")


# ------------------------------------------------------- H-sharded mode
#
# Counterpart: segtpu/models/fast_decoder.py::build_fast_decoder(spatial=
# ...). One process holds every shard: a value is the list of its shards'
# tensors, ``decs[s]`` the folded decoder on shard s's device (shards of
# one device share one). A block shards when ``_block_shards`` says so and
# is computed whole, once per device, otherwise.

def _block_shards(hw, fhw, n_sh: int, halo_req: int) -> bool:
    """Whether a decoder block runs H-sharded: every shard's rows cover
    the cell's largest op halo (a halo exchange reaches one neighbour)
    and each input's rows divide evenly."""
    return (hw[0] % n_sh == 0
            and hw[0] // n_sh >= max(halo_req, 1)
            and all(f[0] % n_sh == 0 for f in fhw))


def decoder_shard_plan(genotype, input_hw, n_shards: int):
    """The sharded decoder's per-block decisions from shapes alone: a
    list of {block, hw, rows_per_shard, halo_req, sharded} and the share
    of decoder and head pixels computed 1/n per shard (the same dict as
    segtpu.models.fast_decoder.decoder_shard_plan)."""
    cell_config, conns = genotype
    ops = [cell_config[0]] + [o for nd in cell_config[1:]
                              for o in (nd[2], nd[3])]
    halo_req = 0
    for o in ops:
        name = OP_NAMES[o]
        if name in _CONV_SPECS:
            k, dil, _ = _CONV_SPECS[name]
            halo_req = max(halo_req, dil * (k // 2))
    h, w = input_hw
    pool = [(h // 4, w // 4), (h // 8, w // 8), (h // 16, w // 16),
            (h // 32, w // 32)]
    rows = []
    px_sh = px_total = 0
    for bi, (i, j) in enumerate(conns):
        fhw = [pool[i], pool[j]]
        hw = (max(f[0] for f in fhw), max(f[1] for f in fhw))
        sh = _block_shards(hw, fhw, n_shards, halo_req)
        pool.append(hw)
        npx = hw[0] * hw[1]
        px_total += npx
        px_sh += npx if sh else 0
        rows.append({"block": bi + 1, "hw": list(hw),
                     "rows_per_shard": hw[0] // n_shards
                     if hw[0] % n_shards == 0 else None,
                     "halo_req": halo_req, "sharded": sh})
    # the head computes each shard's rows at the largest collected size
    head_hw = (h // 4, w // 4)
    px_total += head_hw[0] * head_hw[1]
    px_sh += head_hw[0] * head_hw[1]
    return {"blocks": rows, "head_hw": list(head_hw),
            "sharded_px_fraction": round(px_sh / px_total, 4)}


class _Entry:
    """A pool entry of the sharded decoder: ``ts[s]`` is shard s's
    tensor (or lazy tap), its own rows when ``local``, else the whole
    map (one tensor per device, shared by that device's shards)."""

    def __init__(self, ts, local: bool):
        self.ts, self.local = list(ts), local

    def full_hw(self, n: int):
        shp = self.ts[0].shape
        return (shp[2] * (n if self.local else 1), shp[3])


class ShardedMicroDecoder:
    """The folded micro decoder over H-sharded taps: ``decs[s]`` is the
    ``FoldedMicroDecoder`` on shard s's device. ``__call__(taps)`` takes
    the four taps as lists of the shards' rows and returns the shards'
    rows of the logits [N, K, H/4n, W/4].

    Every conv or sep kernel of a sharded block runs unmodified on the
    shard's rows extended by the op's halo ``dil * (k // 2)`` (an ``acc``
    with them, so the kernel's f32 add is kept) and the edge rows are
    dropped; a fused pair extends both branches by the larger halo; each
    node of the fused cell suffix is one ``cell_op_chw`` call extended
    and cropped on its own, which rounds as the unsharded call's nodes
    do. A sharded resize reads the shard's window through its band of
    the interpolation matrix. All of that gives the unsharded bits. The
    one exception is a global-average-pool branch: its mean is the sum
    of the shards' f32 partial sums over the full count."""

    def __init__(self, decs, *, align_corners: bool = True,
                 use_kernels: bool = True):
        self.decs, self.n = list(decs), len(decs)
        self.ac, self.uk = align_corners, use_kernels
        d0 = self.decs[0]
        self.devices = [d.clf_b.device for d in self.decs]
        ops = [d0.node0[0]] + [op for pair in d0.nodes[0] for op in pair] \
            if len(d0.node0) else []
        self.halo_req = max([op.halo for op in ops], default=0)

    # ---- plumbing
    def _each(self, local: bool, fn):
        """``fn(s)`` for every shard; what is not local is computed once
        per device (by its first shard)."""
        if local:
            return [fn(s) for s in range(self.n)]
        return per_device(self.devices,
                          lambda dev: fn(self.devices.index(dev)))

    def _local(self, e: _Entry):
        if e.local:
            return e.ts
        lr = e.ts[0].shape[2] // self.n
        return [t[:, :, s * lr:(s + 1) * lr].contiguous()
                for s, t in enumerate(e.ts)]

    def _full(self, e: _Entry):
        return gather_h(e.ts) if e.local else e.ts

    # ---- resize
    def _resize_any(self, e: _Entry, hw, shard: bool, acc=None,
                    acc_chain=None):
        """Resize a pool entry (whole or local) to the whole size ``hw``
        (+ ``acc`` or ``acc_chain``, added in the kernel as the unsharded
        decoder adds them). ``shard``: returns the shards' rows, and
        ``acc`` holds rows; else the whole map, and ``acc`` holds whole
        maps. ``acc_chain`` = (the shards' rows of the raw tap, the
        stages per shard, their packed weights per shard)."""
        n, ac, uk = self.n, self.ac, self.uk
        hw = (int(hw[0]), int(hw[1]))
        fh, fw = e.full_hw(n)

        def one(s, x, accs, raws, band=None):
            a = None if accs is None else accs[s]
            ch = None if acc_chain is None else (raws[s], acc_chain[1][s],
                                                 acc_chain[2][s])
            if (fh, fw) == hw:      # nothing to resize: the adds alone
                return _resize(x, tuple(x.shape[2:]), ac, uk, acc=a,
                               acc_chain=ch)
            return resize_chw(x, hw, a, None if ch is None else ch[:2],
                              align_corners=ac, use_kernels=uk, shard=band)

        def whole(accs):
            full = self._full(e)
            raws = None if acc_chain is None else gather_h(acc_chain[0])
            return self._each(False, lambda s: one(s, full[s], accs, raws))

        raws = None if acc_chain is None else acc_chain[0]
        if not shard:
            return _Entry(whole(acc), False)
        if (fh, fw) == hw:
            loc = self._local(e)
            return _Entry([one(s, loc[s], acc, raws) for s in range(n)], True)
        if fh % n == 0:
            _, hu, hd = shard_interp_bands(fh, hw[0], n, ac)
            if max(hu, hd) <= fh // n:     # the halo reaches one neighbour
                ext = halo_exchange(self._local(e), hu, hd)
                return _Entry([one(s, ext[s], acc, raws, (s, n, fh))
                               for s in range(n)], True)
        # else resize the whole map on each device and keep the shard's rows
        full = whole(None if acc is None else gather_h(acc))
        return _Entry(self._local(_Entry(full, False)), True)

    # ---- cell ops on sharded rows
    def _vector(self, sel, xs):
        """A pool branch's [B, C] vector on every shard: the shards' f32
        partial sums added in shard order over the full count."""
        total = sum_shards([per_image(torch.sum, x) for x in xs])
        count = xs[0].shape[2] * self.n * xs[0].shape[3]
        return [sel(d).vector_of_mean(t / count)
                for d, t in zip(self.decs, total)]

    def _sh_op(self, sel, xs, acc=None, vec=None):
        """One cell op on every shard's rows (``sel(dec)`` picks the op
        of a shard's decoder)."""
        op0, uk = sel(self.decs[0]), self.uk
        if op0.kind in ("none", "skip"):
            return [sel(d)(x, None if acc is None else acc[s])
                    for s, (d, x) in enumerate(zip(self.decs, xs))]
        if op0.kind == "gap":
            out = []
            for s, v in enumerate(self._vector(sel, xs)):
                y = v.to(xs[s].dtype)[:, :, None, None].expand(
                    -1, -1, *xs[s].shape[2:])
                out.append(y.contiguous() if acc is None else y + acc[s])
            return out
        he = op0.halo
        if op0.kind == "conv":
            xe = halo_exchange(xs, he, he)
            ae = None if acc is None else halo_exchange(acc, he, he)
            return [crop_h(conv_chw(
                xe[s], sel(d).w, sel(d).b, None if ae is None else ae[s],
                None if vec is None else vec[s], k=op0.k, dilation=op0.dil,
                use_kernels=uk), he, he) for s, d in enumerate(self.decs)]
        xs = self._prefix(sel, xs)
        xe = halo_exchange(xs, he, he)
        ae = None if acc is None else halo_exchange(acc, he, he)
        r = op0.n_reps - 1
        return [crop_h(sep_conv_chw(
            xe[s], *sel(d).rep(r), None if ae is None else ae[s],
            None if vec is None else vec[s], k=op0.k, dilation=op0.dil,
            packed=sel(d).packed(r), use_kernels=uk), he, he)
            for s, d in enumerate(self.decs)]

    def _prefix(self, sel, xs):
        """Every kernel of a sep op but the last, each repeat extended
        and cropped on its own."""
        op0 = sel(self.decs[0])
        if op0.kind == "sep":
            for r in range(op0.n_reps - 1):
                xe = halo_exchange(xs, op0.halo, op0.halo)
                xs = [crop_h(sep_conv_chw(xe[s], *sel(d).rep(r), k=op0.k,
                                          dilation=op0.dil,
                                          packed=sel(d).packed(r),
                                          use_kernels=self.uk),
                             op0.halo, op0.halo)
                      for s, d in enumerate(self.decs)]
        return xs

    def _node_pair(self, sela, xa, selb, xb):
        """One cell node, opb(xb) + opa(xa), as ``_node_pair`` runs it."""
        opa, opb = sela(self.decs[0]), selb(self.decs[0])
        fa, fb = opa.fuse_spec(), opb.fuse_spec()
        if fa is not None and fb is not None:
            he = max(opa.halo, opb.halo)
            x1 = halo_exchange(self._prefix(selb, xb), he, he)
            x2 = halo_exchange(self._prefix(sela, xa), he, he)
            specs = [(selb(d).fuse_spec(), sela(d).fuse_spec())
                     for d in self.decs]
            return [crop_h(pair_op_chw(
                x1[s], sb[1], x2[s], sa[1], op1=fb[0], op2=fa[0],
                packed=(sb[2], sa[2]), use_kernels=self.uk), he, he)
                for s, (sb, sa) in enumerate(specs)]
        if opa.kind == "gap" and fb is not None:
            return self._sh_op(selb, xb, vec=self._vector(sela, xa))
        if opb.kind == "gap" and fa is not None:
            return self._sh_op(sela, xa, vec=self._vector(selb, xb))
        return self._sh_op(selb, xb, acc=self._sh_op(sela, xa))

    def _fused_node(self, sels, outs):
        """One node of the fused cell suffix: ``sels`` is [(op selector,
        source entry)] per branch. One ``cell_op_chw`` call per shard on
        the sources extended by the node's largest halo, then cropped."""
        ops = [sel(self.decs[0]) for sel, _ in sels]
        he = max([op.halo for op in ops], default=0)
        used = sorted({src for (_, src), op in zip(sels, ops)
                       if op.kind not in ("gap", "none")}) or [0]
        ext = {src: halo_exchange(outs[src], he, he) for src in used}
        vecs = {i: self._vector(sel, outs[src])
                for i, ((sel, src), op) in enumerate(zip(sels, ops))
                if op.kind == "gap"}
        res = []
        for s, d in enumerate(self.decs):
            desc = [{"kind": "vec", "vec": vecs[i][s]} if i in vecs
                    else sel(d).branch(used.index(src) if src in used else 0)
                    for i, (sel, src) in enumerate(sels)]
            res.append(crop_h(cell_op_chw(
                [ext[src][s] for src in used], [desc], [len(used)],
                use_kernels=self.uk), he, he))
        return res

    def _cell(self, bi: int, ys):
        """A sharded block's cell on the shards' rows, node for node as
        ``FoldedMicroDecoder._cell`` runs it."""
        d0 = self.decs[0]

        def node0(d):
            return d.node0[bi]

        def branch(k, side):
            return lambda d: d.nodes[bi][k][side]

        wiring = list(d0.cell_config[1:])
        plan = d0._cell_plan(bi)
        start = len(wiring) + 1 if plan is None else plan[1]
        outs = [ys]
        if start >= 1:
            outs.append(self._sh_op(node0, ys))
        for k, (p1, p2, _, _) in enumerate(wiring[:max(start - 1, 0)]):
            outs.append(self._node_pair(branch(k, 0), outs[p1],
                                        branch(k, 1), outs[p2]))
        if plan is not None:
            if start == 0:
                outs.append(self._fused_node([(node0, 0)], outs))
            for k, (p1, p2, _, _) in enumerate(wiring):
                if k + 1 >= max(start, 1):
                    outs.append(self._fused_node(
                        [(branch(k, 0), p1), (branch(k, 1), p2)], outs))
        ents = [outs[c] for c in d0.cell_collect]
        if len(ents) == 1:
            return ents[0]
        if plan is not None:     # the fused suffix sums in its kernel
            return [cell_op_chw([e[s] for e in ents], [],
                                list(range(len(ents))), use_kernels=self.uk)
                    for s in range(self.n)]
        acc = ents[0]
        for e in ents[1:]:
            acc = [a + t for a, t in zip(acc, e)]
        return acc

    # ---- the decoder
    @torch.inference_mode()
    def __call__(self, taps):
        n, uk, decs = self.n, self.uk, self.decs
        d0 = decs[0]
        pool = []
        for i, ts in enumerate(taps):
            pool.append(_Entry(
                [_LazyTap(t, d.adapt[i]) if d0.lazy[i]
                 else conv_chw(t, *d.adapt[i].wb(), k=1, use_kernels=uk)
                 for d, t in zip(decs, ts)], True))
        for bi, (i, j) in enumerate(d0.conns):
            br = [(pool[i], "agg1"), (pool[j], "agg2")]
            fhw = [e.full_hw(n) for e, _ in br]
            hw = (max(f[0] for f in fhw), max(f[1] for f in fhw))
            shard = _block_shards(hw, fhw, n, self.halo_req)
            # resize the branch that needs it last, so that the other
            # rides in as its acc (the order of the unsharded decoder)
            if fhw[1] == hw and fhw[0] != hw:
                br.reverse()
                fhw.reverse()
            (e1, m1), (e2, m2) = br

            def agg(e, m):
                return _Entry(self._each(e.local, lambda s: decs[s]._agg_pw(
                    e.ts[s], getattr(decs[s], m)[bi], uk)), e.local)

            if isinstance(e1.ts[0], _LazyTap) and fhw[0] == hw:
                chain = ([t.x for t in e1.ts],
                         [[t.adapt, getattr(d, m1)[bi].wb()]
                          for d, t in zip(decs, e1.ts)],
                         [[t.packed, getattr(d, m1)[bi].wp]
                          for d, t in zip(decs, e1.ts)])
                y = self._resize_any(agg(e2, m2), hw, shard, acc_chain=chain)
            else:
                y1 = self._resize_any(agg(e1, m1), hw, shard)
                y = self._resize_any(agg(e2, m2), hw, shard, acc=y1.ts)
            if shard:
                pool.append(_Entry(self._cell(bi, y.ts), True))
            else:
                pool.append(_Entry(self._each(False, lambda s: decs[s]._cell(
                    bi, y.ts[s], uk)), False))
        sizes = [pool[i].full_hw(n) for i in d0.collect]
        hw = (max(f[0] for f in sizes), max(f[1] for f in sizes))
        if hw[0] % n:
            raise ValueError(f"the head's {hw[0]} rows do not divide into "
                             f"{n} shards")
        srcs = [self._resize_any(pool[i], hw, True).ts for i in d0.collect]
        return [d._head([src[s] for src in srcs], uk)
                for s, d in enumerate(decs)]


class ShardedTemplateDecoder:
    """The folded template decoder over H-sharded taps, in the JAX
    package's layout for this family (segtpu/engine/inference.py::
    build_sharded_pallas_infer): the taps are gathered along H, the
    decoder runs whole, once per distinct device (``decs[s]`` is the
    ``FoldedTemplateDecoder`` on shard s's device), and each shard keeps
    its h/n rows of the logits. ``__call__(taps)`` takes and returns what
    ``ShardedMicroDecoder`` does. The decoder sees the unsharded taps, so
    its logits are the unsharded decoder's bit for bit."""

    def __init__(self, decs, *, align_corners: bool = True,
                 use_kernels: bool = True):
        self.decs, self.n = list(decs), len(decs)
        self.ac, self.uk = align_corners, use_kernels
        self.devices = [d.clf_b.device for d in self.decs]

    @torch.inference_mode()
    def __call__(self, taps):
        full = [gather_h(ts) for ts in taps]

        def whole(dev):
            s = self.devices.index(dev)
            return self.decs[s]([f[s] for f in full], align_corners=self.ac,
                                use_kernels=self.uk)

        logits = per_device(self.devices, whole)
        rows = logits[0].shape[2]
        if rows % self.n:
            raise ValueError(f"the logits' {rows} rows do not divide into "
                             f"{self.n} shards")
        lq = rows // self.n
        return [x[:, :, s * lq:(s + 1) * lq] for s, x in enumerate(logits)]
