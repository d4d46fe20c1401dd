"""The masked supernet and its population search
(counterpart: segtpu/supernet.py).

One padded supergraph holds every op choice; a sampled genotype is a set
of one-hot masks, and K samples train at once, each with its own
weights and masks on one shared batch of cached encoder taps.

* The supergraph: ``Supernet`` (the micro, CVPR'19 family) and
  ``TemplateSupernet`` (the template, WACV'20 family), ``nn.Module``s
  whose state-dict names mirror the JAX pytrees leaf for leaf
  (``adapt.i``, ``blocks.b.{agg1, agg2, node0.i, nodes.n.{a,b}.i,
  aux_clf}`` or ``blocks.b.{b1, b2, reduce, ops.i, aux_clf}``, and
  ``clf.w`` [pool_max, agg_size, K] with ``clf.b``), so
  ``convert.from_jax.load_jax_params`` carries JAX's weights across.
  ``forward(masks, taps, with_aux)`` takes the four NCHW taps and
  returns ``(logits, aux)``. With one-hot masks a sample's forward is
  its discrete network's, except that every block runs at the stride-4
  resolution (the adapt outputs are resized once); inputs are picked by
  one-hot weighted sums, not by indexing, so a masked-off entry gets a
  zero gradient; the classifier keeps one slice per pool slot (concat-
  equivalent). Masked-off ops still run, and in train mode their
  BatchNorm statistics move.
* The population: ``PopState`` holds every leaf with a leading K axis
  but the shared ``step``. The JAX package ``vmap``s one sample's step;
  here ``torch.func`` does: ``vmap`` over (weights, statistics, masks)
  with the batch shared, ``grad_and_value`` inside, and
  ``functional_call`` runs one skeleton module on each sample's slice.
  Under ``vmap`` a sample's convolution becomes one convolution over the
  population, and ``bn_train``'s in-place running-stat writes land in
  each sample's slice of the stacked buffers. The optimizer clips each
  sample by its own norm (``utils.solvers.PopulationSGD``); Polyak
  averaging takes the count after the step (the first step averages with
  decay 0.5), as the JAX supernet does.
* The search: ``run_supernet_search`` samples K genotypes a round,
  trains them from a fresh population for ``cfg.num_epochs[0]`` epochs
  of the cached batches (stage 1 only), rewards each with its val mIoU
  and makes one batched policy update; with a ``mesh`` the K samples
  split over its ``data`` axis (``parallel.mesh``).
  ``measure_proxy_fidelity`` trains the same genotypes both ways, the
  supernet and the per-genotype stage 1, and returns their rank
  correlation.

Each sample has its own weights: the reference's train-each-arch-from-
scratch protocol, not weight sharing. No hand-written kernel is on this
path: convolutions forward and backward are PyTorch's library calls, as
the JAX package's are XLA's.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from segtpu_torch.core.layers import Conv, ConvBN
from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.engine.trainer import _labels_to, segmentation_loss
from segtpu_torch.ops.layer_factory import NUM_OPS, OP_NAMES, Op
from segtpu_torch.utils.metrics import confusion_matrix
from segtpu_torch.utils.solvers import (PopulationSGD, polyak_decay,
                                        polyak_update, sgd_chain)

log = logging.getLogger("segtpu_torch.supernet")


class SupernetSpec(NamedTuple):
    num_inputs: int = 4
    num_blocks: int = 3
    num_cell_nodes: int = 3
    agg_size: int = 48
    num_classes: int = 21

    @property
    def pool_max(self) -> int:
        return self.num_inputs + self.num_blocks


def _one_hot(a, n: int):
    return F.one_hot(a, n).float()


def masks_from_actions(actions, spec: SupernetSpec) -> Dict[str, torch.Tensor]:
    """Micro controller actions ([n_slots], or [K, n_slots]) -> one-hot
    f32 masks with the same leading axes: ``op0`` [NUM_OPS],
    ``node_pos`` [nodes, 2, nodes + 1], ``node_ops`` [nodes, 2, NUM_OPS],
    ``conns`` [blocks, 2, pool_max]."""
    a = torch.as_tensor(actions).long()
    pair = lambda i, j, n: torch.stack(  # noqa: E731
        [_one_hot(a[..., i], n), _one_hot(a[..., j], n)], -2)
    nn_ = spec.num_cell_nodes
    node_pos, node_ops = [], []
    idx = 1
    for _ in range(nn_):
        node_pos.append(pair(idx, idx + 1, nn_ + 1))
        node_ops.append(pair(idx + 2, idx + 3, NUM_OPS))
        idx += 4
    conns = [pair(idx + 2 * b, idx + 2 * b + 1, spec.pool_max)
             for b in range(spec.num_blocks)]
    return {"op0": _one_hot(a[..., 0], NUM_OPS),
            "node_pos": torch.stack(node_pos, -3),
            "node_ops": torch.stack(node_ops, -3),
            "conns": torch.stack(conns, -3)}


def template_masks_from_actions(actions, spec: SupernetSpec
                                ) -> Dict[str, torch.Tensor]:
    """Template controller actions -> one-hot f32 masks: ``conns``
    [blocks, 2, pool_max], ``aggs`` [blocks, 2], ``ops`` [blocks,
    NUM_OPS], behind the actions' leading axes."""
    a = torch.as_tensor(actions).long()
    conns, aggs, ops = [], [], []
    for b in range(spec.num_blocks):
        i = 4 * b
        conns.append(torch.stack([_one_hot(a[..., i], spec.pool_max),
                                  _one_hot(a[..., i + 1], spec.pool_max)], -2))
        aggs.append(_one_hot(a[..., i + 2], 2))
        ops.append(_one_hot(a[..., i + 3], NUM_OPS))
    return {"conns": torch.stack(conns, -3), "aggs": torch.stack(aggs, -2),
            "ops": torch.stack(ops, -2)}


class AllOps(nn.ModuleList):
    """Every op of ``OP_NAMES`` at width c (``_all_ops_init``); the
    forward is sum_op mask[op] * op(x), summed from op 0 in ``OP_NAMES``
    order: with a one-hot mask, the chosen op."""

    def __init__(self, c: int, *, generator: torch.Generator):
        super().__init__(Op(name, c, generator=generator)
                         for name in OP_NAMES)

    def forward(self, x, op_mask):
        out = None
        for i, op in enumerate(self):
            y = op(x) * op_mask[i].to(x.dtype)
            out = y if out is None else out + y
        return out


class MaskedHead(nn.Module):
    """The concat-equivalent classifier: one [agg_size, K] slice a pool
    slot, ``w`` [pool_max, agg_size, K] (uniform at the fan-in of two
    collected slots) and ``b`` [K]; logits = sum_p collect[p] * (x_p @
    W_p) + b, with collect = clip(1 - used, 0, 1)."""

    def __init__(self, spec: SupernetSpec, *, generator: torch.Generator):
        super().__init__()
        bound = float(np.sqrt(3.0 / (2 * spec.agg_size)))
        self.w = nn.Parameter(torch.empty(
            spec.pool_max, spec.agg_size, spec.num_classes).uniform_(
            -bound, bound, generator=generator))
        self.b = nn.Parameter(torch.zeros(spec.num_classes))

    def forward(self, pool, used):
        collect = torch.clamp(1.0 - used, 0.0, 1.0)
        pool_arr = torch.stack(pool)                      # [P, N, C, H, W]
        wsel = self.w * collect[:, None, None]            # [P, C, K]
        return (torch.einsum("pnchw,pck->nkhw", pool_arr,
                             wsel.to(pool_arr.dtype))
                + self.b.to(pool_arr.dtype)[:, None, None])


def _select(mask, entries):
    """sum_p mask[p] * entries[p]; entries past the list are zeros."""
    arr = torch.stack(entries + [torch.zeros_like(entries[0])]
                      * (mask.shape[-1] - len(entries)))
    return torch.tensordot(mask.to(arr.dtype), arr, dims=1)


class _SupernetBase(nn.Module):
    def __init__(self, spec: SupernetSpec, inp_sizes, *,
                 generator: torch.Generator):
        super().__init__()
        self.spec = spec
        self.adapt = nn.ModuleList(
            ConvBN(c, spec.agg_size, 1, act="relu", generator=generator)
            for c in inp_sizes)

    def _pool(self, taps):
        """The adapted taps, each resized once to the first tap's size."""
        hw = taps[0].shape[-2:]
        return [resize_bilinear(a(t), hw) for a, t in zip(self.adapt, taps)]


class Supernet(_SupernetBase):
    """The micro (CVPR'19) supergraph (``supernet_init`` /
    ``supernet_apply``); masks of ``masks_from_actions``."""

    def __init__(self, spec: SupernetSpec, inp_sizes, *,
                 generator: torch.Generator):
        super().__init__(spec, inp_sizes, generator=generator)
        c, g = spec.agg_size, generator
        self.blocks = nn.ModuleList(nn.ModuleDict({
            "agg1": ConvBN(c, c, 1, act="relu", generator=g),
            "agg2": ConvBN(c, c, 1, act="relu", generator=g),
            "node0": AllOps(c, generator=g),
            "nodes": nn.ModuleList(
                nn.ModuleDict({"a": AllOps(c, generator=g),
                               "b": AllOps(c, generator=g)})
                for _ in range(spec.num_cell_nodes)),
            "aux_clf": Conv(c, spec.num_classes, 1, bias=True, generator=g)})
            for _ in range(spec.num_blocks))
        self.clf = MaskedHead(spec, generator=g)
        self.eval()

    def forward(self, masks, taps, *, with_aux: bool = False):
        spec = self.spec
        pool = self._pool(taps)
        used = torch.zeros_like(masks["conns"][0, 0])
        aux = []
        n_outs = spec.num_cell_nodes + 2
        for b, blk in enumerate(self.blocks):
            cm = masks["conns"][b]
            x1, x2 = _select(cm[0], pool), _select(cm[1], pool)
            used = used + cm[0] + cm[1]
            y = blk["agg1"](x1) + blk["agg2"](x2)
            outs = [y, blk["node0"](y, masks["op0"])]
            # position 0 (the cell input) is consumed by node 0, as the
            # discrete cell's collect starts from used = {0}: without it
            # the input would leak into every cell output no node
            # re-selects it from
            cell_used = (torch.arange(n_outs, device=used.device)
                         == 0).float()
            for n, node in enumerate(blk["nodes"]):
                pm = masks["node_pos"][n]
                pm0 = F.pad(pm[0], (0, n_outs - pm.shape[-1]))
                pm1 = F.pad(pm[1], (0, n_outs - pm.shape[-1]))
                cell_used = cell_used + pm0 + pm1
                ya = node["a"](_select(pm0, outs), masks["node_ops"][n][0])
                yb = node["b"](_select(pm1, outs), masks["node_ops"][n][1])
                outs.append(ya + yb)
            collect = torch.clamp(1.0 - cell_used, 0.0, 1.0)
            cell_out = sum(o * collect[i].to(o.dtype)
                           for i, o in enumerate(outs))
            pool.append(cell_out)
            if with_aux:
                aux.append(blk["aux_clf"](cell_out))
        return self.clf(pool, used), aux


class TemplateSupernet(_SupernetBase):
    """The template (WACV'20) supergraph (``template_supernet_init`` /
    ``template_supernet_apply``): both aggregations run, the sampled one
    is picked by the ``aggs`` one-hot; masks of
    ``template_masks_from_actions``."""

    def __init__(self, spec: SupernetSpec, inp_sizes, *,
                 generator: torch.Generator):
        super().__init__(spec, inp_sizes, generator=generator)
        c, g = spec.agg_size, generator
        self.blocks = nn.ModuleList(nn.ModuleDict({
            "b1": ConvBN(c, c, 1, act="relu", generator=g),
            "b2": ConvBN(c, c, 1, act="relu", generator=g),
            "reduce": ConvBN(2 * c, c, 1, act="relu", generator=g),
            "ops": AllOps(c, generator=g),
            "aux_clf": Conv(c, spec.num_classes, 1, bias=True, generator=g)})
            for _ in range(spec.num_blocks))
        self.clf = MaskedHead(spec, generator=g)
        self.eval()

    def forward(self, masks, taps, *, with_aux: bool = False):
        pool = self._pool(taps)
        used = torch.zeros_like(masks["conns"][0, 0])
        aux = []
        for b, blk in enumerate(self.blocks):
            cm = masks["conns"][b]
            x1, x2 = _select(cm[0], pool), _select(cm[1], pool)
            used = used + cm[0] + cm[1]
            psum = blk["b1"](x1) + blk["b2"](x2)
            cat = blk["reduce"](torch.cat([x1, x2], dim=1))
            am = masks["aggs"][b]
            y = psum * am[0].to(psum.dtype) + cat * am[1].to(cat.dtype)
            y = blk["ops"](y, masks["ops"][b])
            pool.append(y)
            if with_aux:
                aux.append(blk["aux_clf"](y))
        return self.clf(pool, used), aux


SUPERNETS = {"micro": Supernet, "template": TemplateSupernet}
MASK_FNS = {"micro": masks_from_actions,
            "template": template_masks_from_actions}


def family_of(ctrl_version: str) -> str:
    return "template" if ctrl_version in ("wacv", "template") else "micro"


def spec_of(cfg) -> SupernetSpec:
    return SupernetSpec(num_blocks=cfg.num_blocks,
                        num_cell_nodes=cfg.num_cell_nodes,
                        agg_size=cfg.agg_size, num_classes=cfg.num_classes)


# ---------------------------------------------------------------------------
# Population training: torch.func.vmap over (weights, masks), batch shared
# ---------------------------------------------------------------------------


class PopState(NamedTuple):
    """Population training state: name -> tensor maps whose every leaf
    has a leading K axis (``opt_state``: the momentum traces; ``polyak``:
    the averaged parameters, or None), and the shared step count."""
    params: Dict[str, torch.Tensor]
    stats: Dict[str, torch.Tensor]
    opt_state: Dict[str, torch.Tensor]
    polyak: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0

    def eval_params(self):
        """The weights to evaluate with: the Polyak average when kept,
        paired with the live BatchNorm statistics."""
        return self.polyak if self.polyak is not None else self.params

    @property
    def k(self) -> int:
        return next(iter(self.params.values())).shape[0]


def sample_of(tree: Dict[str, torch.Tensor], i: int):
    """Sample i's slice of a K-stacked name -> tensor map."""
    return {n: t[i] for n, t in tree.items()}


def population_init(generator: torch.Generator, spec: SupernetSpec,
                    inp_sizes, k: int, *, family: str = "micro",
                    do_polyak: bool = False, device="cuda") -> PopState:
    """K independent supernets drawn one after another from
    ``generator`` (a CPU generator), stacked on ``device``: zero momentum
    traces, the Polyak average a copy of the weights when ``do_polyak``."""
    from segtpu_torch.utils.helpers import resolve_device
    dev = resolve_device(device)
    nets = [SUPERNETS[family](spec, inp_sizes, generator=generator)
            for _ in range(k)]
    params, stats = (
        {n: torch.stack([t[n].detach() for t in trees]).to(dev)
         for n in trees[0]}
        for trees in ([dict(m.named_parameters()) for m in nets],
                      [dict(m.named_buffers()) for m in nets]))
    return PopState(params, stats,
                    {n: torch.zeros_like(t) for n, t in params.items()},
                    {n: t.clone() for n, t in params.items()}
                    if do_polyak else None, 0)


def _skeleton(spec, family: str, train: bool, inp_sizes=(1, 1, 1, 1)):
    """A module of the family whose tensors functional_call replaces."""
    net = SUPERNETS[family](spec, inp_sizes,
                            generator=torch.Generator().manual_seed(0))
    return net.train(train)


def _taps_label(batch, dev):
    return ([torch.as_tensor(t).to(dev) for t in batch["taps"]],
            _labels_to(batch["label"], dev))


def make_population_grad_fn(spec: SupernetSpec, *, aux_weight: float = 0.15,
                            family: str = "micro"):
    """-> ``grads(params, stats, masks, batch) -> (gradients, losses
    [K])``: each sample's train-mode loss (main and aux heads) and its
    gradient by ``torch.func``, vmapped over K with the batch shared.
    The BatchNorm running stats in ``stats`` move in place."""
    net = _skeleton(spec, family, train=True)

    def one_loss(params, stats, masks, taps, label):
        logits, aux = torch.func.functional_call(
            net, {**params, **stats}, (masks, taps), {"with_aux": True})
        return segmentation_loss(logits, aux, label,
                                 num_classes=spec.num_classes,
                                 aux_weight=aux_weight)

    grad_fn = torch.func.vmap(torch.func.grad_and_value(one_loss),
                              in_dims=(0, 0, 0, None, None))

    def grads(params, stats, masks, batch):
        taps, label = _taps_label(batch, params["adapt.0.w"].device)
        g, losses = grad_fn(params, stats, masks, taps, label)
        return g, losses.detach()

    return grads


def make_population_train_step(spec: SupernetSpec, optimizer: PopulationSGD,
                               *, aux_weight: float = 0.15,
                               family: str = "micro",
                               polyak_decay: float = 0.99):
    """-> ``step(pop, masks, batch) -> (pop, losses [K])``: one stage-1
    step of every sample; ``batch = {'taps': the 4 NCHW taps, 'label':
    int [N, H, W]}`` is shared, ``masks`` K-stacked. Returns a new state
    (the old one's tensors are not changed)."""
    grads_of = make_population_grad_fn(spec, aux_weight=aux_weight,
                                       family=family)

    def step(pop: PopState, masks, batch):
        # bn_train writes the running stats in place: into copies
        stats = {n: s.clone() for n, s in pop.stats.items()}
        grads, losses = grads_of(pop.params, stats, masks, batch)
        params, opt_state = optimizer.update(grads, pop.opt_state,
                                             pop.params)
        n = pop.step + 1
        polyak = None
        if pop.polyak is not None:
            polyak = {k: t.clone() for k, t in pop.polyak.items()}
            polyak_update(polyak, params, polyak_decay, step=n)
        return PopState(params, stats, opt_state, polyak, n), losses

    return step


class GraphedPopulationStep:
    """``make_population_train_step`` on one card as a CUDA graph. A
    step dispatches ~160k PyTorch ops (the vmapped supernet forward and
    backward, its written-out train BatchNorms, the optimizer), so eager
    steps run at the host's pace; here one step is captured at the first
    call, in place on static buffers (weights, statistics, traces,
    Polyak, masks, the batch), and each call copies its batch in, sets
    Polyak's decay (a device scalar) and replays it. The same arithmetic
    as the eager step but for Polyak's add, ``avg * d + p * (1 - d)``.

    ``step(pop, masks, batch) -> (pop, losses [K])`` as the eager step,
    but the returned state's tensors are the graph's buffers: the next
    call changes them. A ``pop`` or ``masks`` other than the last call's
    result is copied in first (a new round's population). On a CPU (the
    tests) the step runs on the same buffers without a graph."""

    def __init__(self, spec: SupernetSpec, optimizer: PopulationSGD, *,
                 aux_weight: float = 0.15, family: str = "micro",
                 polyak_decay: float = 0.99):
        self.grads_of = make_population_grad_fn(spec, aux_weight=aux_weight,
                                                family=family)
        self.optimizer, self.decay = optimizer, polyak_decay
        self.graph = None
        self._pop = self._masks = None

    def _body(self):
        b = self.buf
        grads, losses = self.grads_of(b["params"], b["stats"], b["masks"],
                                      {"taps": b["taps"],
                                       "label": b["label"]})
        params, trace = self.optimizer.update(grads, b["opt_state"],
                                              b["params"])
        names = list(params)
        torch._foreach_copy_([b["params"][n] for n in names],
                             [params[n] for n in names])
        torch._foreach_copy_([b["opt_state"][n] for n in names],
                             [trace[n] for n in names])
        if b["polyak"] is not None:
            avg = [b["polyak"][n] for n in names]
            torch._foreach_mul_(avg, b["d"])
            torch._foreach_add_(avg, torch._foreach_mul(
                [params[n] for n in names], 1.0 - b["d"]))
        b["losses"] = losses

    def _capture(self, pop, masks, batch):
        clone = lambda t: None if t is None else {  # noqa: E731
            k: v.clone() for k, v in t.items()}
        dev = pop.params["adapt.0.w"].device
        self.buf = {"params": clone(pop.params), "stats": clone(pop.stats),
                    "opt_state": clone(pop.opt_state),
                    "polyak": clone(pop.polyak), "masks": clone(masks),
                    "taps": [torch.as_tensor(t).to(dev).clone()
                             for t in batch["taps"]],
                    "label": _labels_to(batch["label"], dev).clone(),
                    "d": torch.zeros((), device=dev)}
        if dev.type != "cuda":      # the tests: the buffers, no graph
            self.graph = self._body
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):   # warm-up (cuDNN, cuBLAS, caches)
            self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        self.graph = graph.replay

    def __call__(self, pop: PopState, masks, batch):
        if self.graph is None:
            self._capture(pop, masks, batch)
        b = self.buf
        if pop is not self._pop:
            for f in ("params", "stats", "opt_state", "polyak"):
                if b[f] is not None:
                    names = list(b[f])
                    torch._foreach_copy_([b[f][n] for n in names],
                                         [getattr(pop, f)[n] for n in names])
        if masks is not self._masks:
            for n, t in masks.items():
                b["masks"][n].copy_(t)
            self._masks = masks
        for dst, t in zip(b["taps"], batch["taps"]):
            dst.copy_(t)
        b["label"].copy_(batch["label"])
        n = pop.step + 1
        b["d"].fill_(polyak_decay(self.decay, n))
        self.graph()
        self._pop = PopState(b["params"], b["stats"], b["opt_state"],
                             b["polyak"], n)
        return self._pop, b["losses"]


def make_sequential_train_step(spec: SupernetSpec, optimizer: PopulationSGD,
                               *, aux_weight: float = 0.15,
                               family: str = "micro",
                               polyak_decay: float = 0.99):
    """The population step taken one sample after another, as the
    trainer takes a step: each sample's supernet module in train mode,
    autograd, the one-group ``sgd_chain`` of the optimizer's settings
    (one norm over the sample's gradients), Polyak at the count after
    the step. The reference that the vectorised step is held to; the
    same signature and result."""
    g = optimizer.group

    def step(pop: PopState, masks, batch):
        dev = pop.params["adapt.0.w"].device
        net = _skeleton(spec, family, True, [
            pop.params[f"adapt.{i}.w"].shape[2]
            for i in range(spec.num_inputs)]).to(dev)
        taps, label = _taps_label(batch, dev)
        n, out, losses = pop.step + 1, [], []
        for i in range(pop.k):
            net.load_state_dict({**sample_of(pop.params, i),
                                 **sample_of(pop.stats, i)})
            logits, aux = net(sample_of(masks, i), taps, with_aux=True)
            loss = segmentation_loss(logits, aux, label,
                                     num_classes=spec.num_classes,
                                     aux_weight=aux_weight)
            named = dict(net.named_parameters())
            grads = torch.autograd.grad(loss, list(named.values()))
            trace = {k: t.clone() for k, t in
                     sample_of(pop.opt_state, i).items()}
            sgd_chain(g.lr, momentum=g.momentum, wd=g.wd, clip=g.clip).update(
                dict(zip(named, grads)), trace, named)
            params = {k: p.detach().clone() for k, p in named.items()}
            polyak = None
            if pop.polyak is not None:
                polyak = {k: t.clone() for k, t in
                          sample_of(pop.polyak, i).items()}
                polyak_update(polyak, params, polyak_decay, step=n)
            out.append((params, {k: b.clone() for k, b in
                                 net.named_buffers()}, trace, polyak))
            losses.append(loss.detach())
        stack = lambda j: {k: torch.stack([o[j][k] for o in out])  # noqa
                           for k in out[0][j]}
        return (PopState(stack(0), stack(1), stack(2),
                         stack(3) if pop.polyak is not None else None, n),
                torch.stack(losses))

    return step


def make_population_eval_step(spec: SupernetSpec, *, family: str = "micro"):
    """-> ``step(params, stats, masks, batch) -> [K, C, C]``: each
    sample's eval-mode logits resized in f32 to the labels' size, argmax
    (ties to the lower class), confusion matrix."""
    net = _skeleton(spec, family, train=False)

    def one(params, stats, masks, taps):
        return torch.func.functional_call(net, {**params, **stats},
                                          (masks, taps))[0]

    logits_fn = torch.func.vmap(one, in_dims=(0, 0, 0, None))

    @torch.no_grad()
    def step(params, stats, masks, batch):
        dev = next(iter(params.values())).device
        taps, label = _taps_label(batch, dev)
        logits = logits_fn(params, stats, masks, taps)
        logits = resize_bilinear(logits, label.shape[-2:],
                                 compute_dtype=torch.float32)
        return torch.stack([confusion_matrix(p, label, spec.num_classes)
                            for p in torch.argmax(logits.float(), dim=2)])

    return step


def population_optimizer(cfg) -> PopulationSGD:
    """The per-genotype search's stage-1 chain (clip, weight decay,
    momentum 0.9), per sample."""
    return PopulationSGD(cfg.dec_lr, momentum=0.9, wd=cfg.dec_wd,
                         clip=cfg.dec_grad_clip)


def stage1_step(spec, optimizer, device, *, aux_weight: float,
                family: str = "micro", mesh=None):
    """The search's population step: on one card the CUDA graph
    (``GraphedPopulationStep``), else (a CPU, or a mesh, whose shards
    each hold their own slice) the eager vmapped step."""
    if torch.device(device).type == "cuda" and mesh is None:
        return GraphedPopulationStep(spec, optimizer, aux_weight=aux_weight,
                                     family=family)
    return make_population_train_step(spec, optimizer,
                                      aux_weight=aux_weight, family=family)


def _sync(dev) -> float:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _stage1(pop, masks, cached_train, cached_val, train_step, eval_step,
            epochs: int, num_classes: int):
    """``epochs`` passes of the population over the cached batches in
    their fixed order, then each sample's confusion matrix summed over
    the cached val batches -> (pop, [K, C, C] numpy, population steps)."""
    steps = 0
    for _ in range(epochs):
        for batch in cached_train:
            pop, _ = train_step(pop, masks, batch)
            steps += 1
    cms = 0
    for batch in cached_val:
        cms = cms + eval_step(pop.eval_params(), pop.stats, masks,
                              batch).cpu().numpy()
    return pop, np.asarray(cms), steps


def run_supernet_search(cfg, *, population: int = 8, dataset=None,
                        encoder=None, mesh=None, device="cuda"):
    """NAS search with the vectorised population trainer. Each round
    samples ``population`` genotypes, trains them at once from a fresh
    population for ``cfg.num_epochs[0]`` epochs of the cached taps
    (stage 1 only), rewards each with its val mIoU and makes one batched
    policy update. ``cfg.num_iters`` counts rounds. ``mesh``: a
    ``parallel.mesh.DeviceMesh`` whose ``data`` axis splits the K samples
    (each device trains its slice, no collectives); the search then runs
    on its first device. Records carry ``round``, ``mode`` ("supernet"),
    ``baseline``, ``entropy`` (the sample's summed slot entropy, nats),
    ``seconds`` (the round's) and ``stage1_ms`` (ms a population step).
    Returns the ``SearchSaver``."""
    from segtpu_torch import search as S
    from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS
    from segtpu_torch.rl import controller as ctrl
    from segtpu_torch.rl.agent import sample_genotype, train_agent_batch
    from segtpu_torch.utils.helpers import resolve_device
    from segtpu_torch.utils.metrics import mean_iou
    from segtpu_torch.utils.saver import SearchSaver

    dev = resolve_device(mesh.devices[0] if mesh is not None else device)
    k = population
    _, encoder, loaders = S.search_setup(cfg, dataset, encoder, dev)
    cached_train = S._cache_taps(encoder, loaders["cache_train"])
    cached_val = S._cache_taps(encoder, loaders["cache_val"])

    family = family_of(cfg.ctrl_version)
    spec = spec_of(cfg)
    agent = S.create_search_agent(cfg, dev)
    train_step = stage1_step(spec, population_optimizer(cfg), dev,
                             aux_weight=cfg.dec_aux_weight, family=family,
                             mesh=mesh)
    eval_step = make_population_eval_step(spec, family=family)
    if mesh is not None:
        from segtpu_torch.parallel.mesh import (make_sharded_population_eval,
                                                make_sharded_population_step,
                                                shard_population)
        train_step = make_sharded_population_step(train_step, mesh)
        eval_step = make_sharded_population_eval(eval_step, mesh)
    decode = (ctrl.genotype_from_actions if family == "micro"
              else ctrl.template_genotype_from_actions)
    saver = SearchSaver(cfg.snapshot_dir)

    for rnd in range(cfg.num_iters):
        t0 = _sync(dev)
        draws = [sample_genotype(agent, torch.Generator(device=dev)
                                 .manual_seed(S._seed(cfg.seed, 2, rnd, i)))
                 for i in range(k)]
        acts = torch.stack([d[1] for d in draws])
        genos = [decode(a, agent.spec) for a in acts]
        ents = [float(d[3].sum()) for d in draws]
        masks = MASK_FNS[family](acts, spec)
        pop = population_init(
            torch.Generator().manual_seed(S._seed(cfg.seed, 3, rnd)), spec,
            MBV2_TAP_CHANNELS, k, family=family, do_polyak=cfg.do_polyak,
            device=dev)
        if mesh is not None:
            pop, masks = shard_population(mesh, pop, masks)
        t1 = _sync(dev)
        pop, cms, steps = _stage1(pop, masks, cached_train, cached_val,
                                  train_step, eval_step, cfg.num_epochs[0],
                                  cfg.num_classes)
        stage1_ms = 1e3 * (_sync(dev) - t1) / max(steps, 1)
        rewards = [mean_iou(cms[i]) for i in range(k)]
        agent = train_agent_batch(agent, acts, rewards,
                                  old_logprobs_batch=torch.stack(
                                      [d[2] for d in draws]))
        seconds = round(time.perf_counter() - t0, 3)
        for i in range(k):
            saver.record(rnd * k + i, genos[i], rewards[i],
                         {"round": rnd, "mode": "supernet",
                          "baseline": float(agent.state.baseline),
                          "entropy": round(ents[i], 4), "seconds": seconds,
                          "stage1_ms": stage1_ms})
        log.info("supernet round %d: %d archs in %.1fs rewards %s", rnd, k,
                 seconds, [round(float(r), 4) for r in rewards])
        saver.save((rnd + 1) * k, agent.state.params,
                   float(agent.state.baseline))
    return saver


# ---------------------------------------------------------------------------
# Proxy fidelity: does the supernet rank genotypes as the per-genotype
# stage 1 does?
# ---------------------------------------------------------------------------


def measure_proxy_fidelity(cfg, *, k: int = 16, seed: int = 0, dataset=None,
                           encoder=None, genotypes=None,
                           discrete_only: bool = False, device="cuda"):
    """Train K micro genotypes both ways on the same cached taps: the
    per-genotype stage-1 proxy (``search.proxy_train``'s stage 1) and the
    supernet population (``run_supernet_search``'s stage 1). Returns
    (spearman, per-genotype rewards, supernet rewards, genotypes).
    ``genotypes``: fixed genotypes instead of K distinct ones sampled
    from an untrained controller; ``discrete_only``: skip the supernet
    and return (None, per-genotype rewards, None, genotypes)."""
    from segtpu_torch import search as S
    from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS
    from segtpu_torch.rl import controller as ctrl
    from segtpu_torch.rl.agent import create_agent, sample_genotype
    from segtpu_torch.utils.helpers import resolve_device
    from segtpu_torch.utils.metrics import mean_iou, spearman

    dev = resolve_device(device)
    _, encoder, loaders = S.search_setup(cfg, dataset, encoder, dev,
                                      enc_seed=S._seed(seed, 0))
    cached_train = S._cache_taps(encoder, loaders["cache_train"])
    cached_val = S._cache_taps(encoder, loaders["cache_val"])
    spec = spec_of(cfg)
    cspec = ctrl.MicroControllerSpec(
        num_blocks=cfg.num_blocks, num_cell_nodes=cfg.num_cell_nodes,
        hidden_size=cfg.lstm_hidden_size, emb_size=cfg.op_size)
    if genotypes is not None:
        genos = list(genotypes)
        acts = [ctrl.actions_from_genotype(g, cspec) for g in genos]
    else:
        # K distinct genotypes (an untrained controller repeats itself)
        agent = create_agent(torch.Generator().manual_seed(S._seed(seed, 1)),
                             spec=cspec, device=dev)
        genos, acts, seen = [], [], set()
        for i in range(50 * k):
            if len(genos) == k:
                break
            g, a, _, _ = sample_genotype(agent, torch.Generator(device=dev)
                                         .manual_seed(S._seed(seed, 2, i)))
            if repr(g) not in seen:
                seen.add(repr(g))
                genos.append(g)
                acts.append(a)

    r_discrete = _fidelity_discrete_rewards(cfg, genos, cached_train,
                                            cached_val, seed, dev)
    if discrete_only:
        return None, r_discrete, None, genos
    masks = masks_from_actions(torch.stack([torch.as_tensor(a) for a in acts])
                               .to(dev), spec)
    pop = population_init(torch.Generator().manual_seed(S._seed(seed, 3)),
                          spec, MBV2_TAP_CHANNELS, len(genos),
                          do_polyak=cfg.do_polyak, device=dev)
    _, cms, _ = _stage1(
        pop, masks, cached_train, cached_val,
        stage1_step(spec, population_optimizer(cfg), dev,
                    aux_weight=cfg.dec_aux_weight),
        make_population_eval_step(spec), cfg.num_epochs[0], cfg.num_classes)
    r_supernet = [mean_iou(cms[i]) for i in range(len(genos))]
    return spearman(r_discrete, r_supernet), r_discrete, r_supernet, genos


def _fidelity_discrete_rewards(cfg, genos, cached_train, cached_val,
                               seed: int, device):
    """Each genotype's per-genotype stage-1 reward (``search.
    stage1_reward``, decoder seed ``_seed(seed, 4, i)``) on the cached
    taps."""
    from segtpu_torch import search as S
    return [S.stage1_reward(g, cfg, cached_train, cached_val,
                            rng_seed=S._seed(seed, 4, i), device=device)[0]
            for i, g in enumerate(genos)]
