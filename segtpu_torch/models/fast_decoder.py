"""The micro decoder with BatchNorm folded, every op a fused kernel
(counterpart: segtpu/models/fast_decoder.py::build_fast_decoder, the
single-device path).

``fold_decoder(dec, compute_dtype)`` folds eval BatchNorm into the conv
weights of a ``MicroDecoder`` from its f32 weights and returns a
``FoldedMicroDecoder`` whose forward takes the four NCHW encoder taps
and returns the logits [N, K, H/4, W/4], with the JAX fast decoder's
structure:

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

Dense weights are rounded to the compute dtype after folding in f32;
depthwise weights, the pool's 1x1 and all biases stay f32.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from segtpu_torch.kernels.chw_ops import (cell_op_chw, conv_chw,
                                          pair_op_chw, pw_chain_chw,
                                          pw_multi_chw, sep_conv_chw)
from segtpu_torch.kernels.resize_chw import resize_chw
from segtpu_torch.models.fast_encoder import _fold
from segtpu_torch.models.micro_decoders import (MicroDecoder,
                                                _cell_collect_inds)
from segtpu_torch.ops.layer_factory import _CONV_SPECS


class FoldedOp(nn.Module):
    """One cell op with BN folded: kind "skip", "none", "gap", "conv" or
    "sep" (its repeats as buffers ``dw{r}``/``bdw{r}``/``pw{r}``/
    ``bpw{r}``)."""

    def __init__(self, op, compute_dtype):
        super().__init__()
        name = op.name
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
        else:
            self.kind = "conv"
            w, b = _fold(op.conv)
            self.register_buffer("w", w.to(compute_dtype))
            self.register_buffer("b", b)

    def rep(self, r: int):
        return (getattr(self, f"dw{r}"), getattr(self, f"bdw{r}"),
                getattr(self, f"pw{r}"), getattr(self, f"bpw{r}"))

    def vector(self, x):
        """The pool op's [B, C] f32 result, relu(mean(x) @ w + b), without
        its spatial broadcast."""
        pooled = x.float().mean((2, 3))
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
                                 dilation=self.dil, use_kernels=use_kernels)
            return x
        return conv_chw(x, self.w, self.b, acc, vec_acc, k=self.k,
                        dilation=self.dil, use_kernels=use_kernels)

    def fuse_spec(self):
        """(op, weights) of this op's last kernel for ``pair_op_chw``, or
        None (gap, skip, none)."""
        if self.kind == "conv":
            return ("conv", self.k, self.dil), (self.w, self.b)
        if self.kind == "sep":
            return ("sep", self.k, self.dil), self.rep(self.n_reps - 1)
        return None

    def prefix(self, x, use_kernels: bool):
        """Every kernel of the op but the last (sep repeats > 1)."""
        if self.kind == "sep":
            for r in range(self.n_reps - 1):
                x = sep_conv_chw(x, *self.rep(r), k=self.k,
                                 dilation=self.dil, use_kernels=use_kernels)
        return x

    def branch(self, entry: int):
        """This op as a ``cell_op_chw`` branch reading ``entry`` (single
        repeat; gap vectors are added by the caller)."""
        if self.kind == "conv":
            return {"kind": "conv", "entry": entry, "k": self.k,
                    "dil": self.dil, "w": self.w, "b": self.b}
        if self.kind == "sep":
            wdw, bdw, wpw, bpw = self.rep(0)
            return {"kind": "sep", "entry": entry, "k": self.k,
                    "dil": self.dil, "wdw": wdw, "bdw": bdw, "wpw": wpw,
                    "bpw": bpw}
        if self.kind == "skip":
            return {"kind": "skip", "entry": entry}
        return {"kind": "none"}


class _LazyTap:
    """A tap whose 1x1 adapt is deferred into its one consumer's kernel;
    ``shape`` is the adapted shape."""

    def __init__(self, x, adapt):
        self.x, self.adapt = x, adapt
        self.shape = (x.shape[0], adapt[0].shape[0], *x.shape[2:])


def _node_pair(opa, xa, opb, xb, uk: bool):
    """One cell node, opb(xb) + opa(xa), in the fewest kernels: both
    branches in ``pair_op_chw`` when both end in a conv, a pool branch
    as the partner's ``vec_acc``, else opa's output as opb's ``acc``."""
    fa, fb = opa.fuse_spec(), opb.fuse_spec()
    if fa is not None and fb is not None:
        return pair_op_chw(opb.prefix(xb, uk), fb[1], opa.prefix(xa, uk),
                           fa[1], op1=fb[0], op2=fa[0], use_kernels=uk)
    if opa.kind == "gap" and fb is not None:
        return opb(xb, vec_acc=opa.vector(xa), use_kernels=uk)
    if opb.kind == "gap" and fa is not None:
        return opa(xa, vec_acc=opb.vector(xb), use_kernels=uk)
    return opb(xb, acc=opa(xa, use_kernels=uk), use_kernels=uk)


class FoldedMicroDecoder(nn.Module):
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
        if dec.clf.w.dtype != torch.float32:
            raise ValueError("fold_decoder folds f32 weights: fold before "
                             "casting")
        self.register_buffer("clf_w", dec.clf.w.detach().to(compute_dtype))
        self.register_buffer("clf_b", dec.clf.b.detach().float())
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

    @staticmethod
    def _resize(x, hw, ac: bool, uk: bool, acc=None, acc_chain=None):
        if tuple(x.shape[2:]) == hw:
            if acc_chain is not None:
                acc = pw_chain_chw(acc_chain[0], acc_chain[1], use_kernels=uk)
            return x if acc is None else x + acc
        return resize_chw(x, hw, acc, acc_chain, align_corners=ac,
                          use_kernels=uk)

    def forward(self, taps, *, align_corners: bool = True,
                use_kernels: bool = True):
        uk, ac = use_kernels, align_corners

        def agg_pw(entry, mod):
            if isinstance(entry, _LazyTap):
                return pw_chain_chw(entry.x, [entry.adapt, mod.wb()],
                                    use_kernels=uk)
            return conv_chw(entry, *mod.wb(), k=1, use_kernels=uk)

        pool: List = []
        for lazy, t, a in zip(self.lazy, taps, self.adapt):
            pool.append(_LazyTap(t, a.wb()) if lazy
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
                y = self._resize(agg_pw(e2, m2), hw, ac, uk,
                                 acc_chain=(e1.x, [e1.adapt, m1.wb()]))
            else:
                y = self._resize(agg_pw(e2, m2), hw, ac, uk,
                                 acc=self._resize(agg_pw(e1, m1), hw, ac, uk))
            pool.append(self._cell(bi, y, uk))
        hw = (max(pool[i].shape[2] for i in self.collect),
              max(pool[i].shape[3] for i in self.collect))
        srcs = [self._resize(pool[i], hw, ac, uk) for i in self.collect]
        if len(srcs) == 1:
            return conv_chw(srcs[0], self.clf_w, self.clf_b, k=1, act="none",
                            use_kernels=uk)
        ws, off = [], 0
        for s in srcs:
            ws.append(self.clf_w[:, off:off + s.shape[1]])
            off += s.shape[1]
        return pw_multi_chw(srcs, ws, self.clf_b, act="none", use_kernels=uk)


class _Folded1x1(nn.Module):
    """A 1x1 conv-bn-relu with BN folded (dense weight in the compute
    dtype, f32 bias)."""

    def __init__(self, conv_bn, compute_dtype):
        super().__init__()
        w, b = _fold(conv_bn)
        self.register_buffer("w", w.to(compute_dtype))
        self.register_buffer("b", b)

    def wb(self):
        return self.w, self.b


def fold_decoder(dec: MicroDecoder, compute_dtype=torch.bfloat16
                 ) -> FoldedMicroDecoder:
    """A ``FoldedMicroDecoder`` of ``dec``'s f32 weights, on dec's device."""
    return FoldedMicroDecoder(dec, compute_dtype).eval()
