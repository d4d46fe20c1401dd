"""Device meshes, sharded inference and data-parallel training in one
process (counterpart: segtpu/parallel/mesh.py).

The JAX package shards with ``shard_map`` over a ``jax.sharding.Mesh``.
PyTorch's idiom here is explicit: one process holds every device, a
mesh is a (data, space) grid of ``torch.device``s, and a sharded
function loops over them (``parallel.collectives``). A device may appear
several times in the grid: n logical shards on one card, the
counterpart of the JAX tests' virtual CPU mesh, which runs every halo
exchange, crop and per-shard band for real, one shard after another.
There is no ``torch.distributed`` here.

Sharded training splits the batch over the ``data`` axis and each
image's rows over the ``space`` axis (``shard_batch``) and keeps one set
of weights. Its step (``make_sharded_train_step``) is the unsharded step
on the whole batch up to rounding, as the JAX package's is: BatchNorm's
moments, the loss and the gradients are the whole batch's, and each op
that reads across rows meets the shards of its row (``core.bands``).

The supernet's population steps shard the population: each device of
the mesh's ``data`` axis holds K/data samples (``shard_population``)
and runs the unsharded step on its slice, with no collectives; the
per-sample outputs are gathered onto the mesh's first device in K
order (``make_sharded_population_step``/``_eval``).
"""

from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from segtpu_torch.core.bands import ShardGroup, band, shard_context


class DeviceMesh:
    """A (data, space) grid of devices, row-major."""

    def __init__(self, grid: List[List[torch.device]]):
        self.grid = grid
        self.shape = {"data": len(grid), "space": len(grid[0])}
        self.size = self.shape["data"] * self.shape["space"]

    @property
    def devices(self) -> List[torch.device]:
        """Every device of the grid in row-major order."""
        return [d for row in self.grid for d in row]


def make_mesh(data: int, space: int = 1, *,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (data, space) mesh of the first ``data * space`` of ``devices``
    (default: every CUDA device). Too few devices raise ``ValueError``.
    A caller may repeat a device (``[torch.device("cuda:0")] * 4``) or
    pass CPU devices, as the tests do."""
    if data < 1 or space < 1:
        raise ValueError(f"mesh axes must be >= 1, got {(data, space)}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = data * space
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return DeviceMesh([devices[r * space:(r + 1) * space]
                       for r in range(data)])


def make_sharded_infer_fn(seg, mesh: DeviceMesh, *, mode: str = "data"):
    """Shard the serving engine ``seg`` (``engine.Segmenter``) over the
    mesh. Returns ``run(imgs_u8)``: uint8 [N, H, W, 3] -> uint8 masks
    [N, H, W]; numpy in gives numpy out, a tensor in gives a tensor on
    the mesh's first device.

    mode='data' — the batch is cut into ``mesh.size`` equal parts and
      every device runs the whole engine on its part; N must divide by
      the mesh size. Masks are those of the unsharded engine bit for bit.
    mode='space' — every frame is cut along H over the mesh's 'space'
      axis and the batch is not split (a mesh with data = 1): the
      counterpart of ``make_sharded_pallas_infer_fn``, see
      ``engine.ShardedSegmenter``. The JAX package's other 'space' mode
      hands an unsharded program to XLA's GSPMD partitioner; PyTorch has
      no partitioner, so that mode has no counterpart here.
    """
    if mode == "data":
        devices = mesh.devices
        replicas = [seg.replica(d) for d in devices]

        def run(img_u8):
            as_numpy = not isinstance(img_u8, torch.Tensor)
            imgs = torch.from_numpy(np.ascontiguousarray(
                img_u8, dtype=np.uint8)) if as_numpy else img_u8
            if imgs.ndim != 4:
                raise ValueError(f"sharded inference takes [N, H, W, 3], "
                                 f"got {tuple(imgs.shape)}")
            if imgs.shape[0] % mesh.size:
                raise ValueError(f"batch {imgs.shape[0]} must divide mesh "
                                 f"size {mesh.size}")
            per = imgs.shape[0] // mesh.size
            parts = [rep.infer(imgs[i * per:(i + 1) * per].to(dev))
                     for i, (rep, dev) in enumerate(zip(replicas, devices))]
            out = torch.cat([p.to(devices[0]) for p in parts], dim=0)
            return out.cpu().numpy() if as_numpy else out

        return run

    if mode == "space":
        if mesh.shape["data"] != 1:
            raise ValueError(
                f"mode='space' does not split the batch: it takes a "
                f"(1, n) mesh, got {mesh.shape}")
        from segtpu_torch.engine.inference import ShardedSegmenter
        return ShardedSegmenter(seg, mesh.grid[0]).predict

    raise ValueError(f"unknown mode {mode!r} (use 'data' or 'space')")


class PopShards(list):
    """A supernet population split over a mesh's ``data`` axis: one
    ``supernet.PopState`` a device, in K order. ``eval_params()`` and
    ``stats`` give the shards' maps, as the sharded eval takes them."""

    def eval_params(self):
        return [p.eval_params() for p in self]

    @property
    def stats(self):
        return [p.stats for p in self]

    @property
    def step(self) -> int:
        return self[0].step


def _data_devices(mesh: DeviceMesh) -> List[torch.device]:
    """One device a row of the ``data`` axis (the row's first)."""
    return [row[0] for row in mesh.grid]


def shard_population(mesh: DeviceMesh, pop, masks):
    """-> (``PopShards``, one mask map a shard): sample k of the
    population (a ``supernet.PopState``) and of its K-stacked masks goes
    to the data row k // (K / data); the shared step is replicated. Every
    leaf's K must divide by the ``data`` axis, else ``ValueError``."""
    devices = _data_devices(mesh)
    data = len(devices)
    trees = [t for t in (pop.params, pop.stats, pop.opt_state, pop.polyak,
                         masks) if t is not None]
    for t in trees:
        for name, x in t.items():
            if x.shape[0] % data:
                raise ValueError(f"population {x.shape[0]} ({name}) not "
                                 f"divisible by data={data}")
    per = pop.k // data

    def part(tree, r):
        return None if tree is None else {
            n: x[r * per:(r + 1) * per].to(devices[r])
            for n, x in tree.items()}

    return (PopShards(pop._replace(params=part(pop.params, r),
                                   stats=part(pop.stats, r),
                                   opt_state=part(pop.opt_state, r),
                                   polyak=part(pop.polyak, r))
                      for r in range(data)),
            [part(masks, r) for r in range(data)])


def gather_population(shards):
    """The shards of ``shard_population`` as one ``PopState`` on the
    first shard's device."""
    dev = shards[0].params[next(iter(shards[0].params))].device

    def cat(trees):
        return None if trees[0] is None else {
            n: torch.cat([t[n].to(dev) for t in trees]) for n in trees[0]}

    return shards[0]._replace(
        **{f: cat([getattr(p, f) for p in shards])
           for f in ("params", "stats", "opt_state", "polyak")})


def make_sharded_population_step(step_fn, mesh: DeviceMesh):
    """-> ``step(shards, masks, batch) -> (shards, losses [K])``: the
    unsharded population step ``step_fn(pop, masks, batch)`` on each
    shard of ``shard_population`` in turn (each moves the shared batch to
    its device), no collectives; the losses gathered onto the mesh's
    first device in K order. Logical shards on one device run one after
    another, as every sharded path here does."""
    dev0 = mesh.devices[0]

    def step(shards, masks, batch):
        outs = [step_fn(p, m, batch) for p, m in zip(shards, masks)]
        return (PopShards(o[0] for o in outs),
                torch.cat([o[1].to(dev0) for o in outs]))

    return step


def make_sharded_population_eval(eval_fn, mesh: DeviceMesh):
    """-> ``eval(params, stats, masks, batch) -> [K, C, C]``: the
    unsharded population eval on each shard's maps (lists, as
    ``PopShards.eval_params()`` and ``.stats`` give them), the confusion
    matrices gathered onto the mesh's first device in K order."""
    dev0 = mesh.devices[0]

    def run(params, stats, masks, batch):
        return torch.cat([eval_fn(p, s, m, batch).to(dev0)
                          for p, s, m in zip(params, stats, masks)])

    return run


def _run_shards(workers, mesh: DeviceMesh, fn, shards) -> list:
    """``fn(rank, device, shard)`` for each device of the mesh (row-major
    rank) and its shard, each in a thread of ``workers``, on its device,
    inside ``shard_context`` (the whole mesh's group; its data row's
    group along ``space``): the results in rank order. A shard that
    fails lets the others' meetings go, and the first failure is raised
    here."""
    space = mesh.shape["space"]
    group = ShardGroup(mesh.size)
    rows = [ShardGroup(space) for _ in range(mesh.shape["data"])]

    def run(r, dev, shard):
        try:
            on_dev = (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext())
            with on_dev, shard_context(group, r, rows[r // space],
                                       r % space):
                return fn(r, dev, shard)
        except BaseException:
            # the other shards' waits raise instead of hanging
            for g in (group, *rows):
                g.abort()
            raise

    futures = [workers.submit(run, r, dev, shard) for r, (dev, shard)
               in enumerate(zip(mesh.devices, shards))]
    failed = [e for e in (f.exception() for f in futures) if e is not None]
    if failed:
        # the first failure, not the others' broken barriers
        raise next((e for e in failed
                    if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    return [f.result() for f in futures]


def _shard_workers(mesh: DeviceMesh, owner) -> ThreadPoolExecutor:
    """One long-lived thread a shard, shut down when ``owner`` is
    collected: PyTorch keeps cuDNN's convolution plans per thread, and a
    new thread each call would plan them anew."""
    workers = ThreadPoolExecutor(max_workers=mesh.size,
                                 thread_name_prefix="segtpu-shard")
    weakref.finalize(owner, workers.shutdown, wait=False)
    return workers


def shard_batch(mesh: DeviceMesh, batch) -> List[dict]:
    """A batch dict cut over the mesh as the JAX package places it
    (``P("data", "space", None, None)``): one dict a device, in the
    mesh's row-major order, with its part of ``image`` [N, H, W, 3] and
    ``label`` [N, H, W] (N over ``data``, H over ``space``) and of the
    optional ``teacher`` [N, K, h, w] (N over ``data``, its own h over
    ``space``) on that device (numpy or tensors in, tensors out; other
    entries as they are). Shard s of the ``space`` axis's n takes rows
    [s*H//n, (s+1)*H//n), ``core.bands``'s rule (JAX's even split where
    n divides H). N must divide by the ``data`` axis, else
    ``ValueError``. The JAX package returns one array sharded over the
    mesh; here the shards are a list, as PyTorch has no sharded
    tensor."""
    data, space = mesh.shape["data"], mesh.shape["space"]
    n = len(batch["image"])
    if n % data:
        raise ValueError(f"batch {n} must divide the data axis {data}")
    per = n // data
    out = []
    for r, dev in enumerate(mesh.devices):
        d, s = divmod(r, space)
        part = dict(batch)
        for key, axis in (("image", 1), ("label", 1), ("teacher", 2)):
            if key in batch:
                x = torch.as_tensor(batch[key])[d * per:(d + 1) * per]
                lo, hi = band(x.shape[axis], space, s)
                part[key] = x.narrow(axis, lo, hi - lo).to(dev)
        out.append(part)
    return out


def make_sharded_train_step(step_fn, mesh: DeviceMesh):
    """-> ``step(state, batch) -> (state, loss)``: ``step_fn`` (a
    ``make_train_step`` step, whose ``StepParts`` it reads) with the
    batch (the unsharded step's dict) cut over the mesh by
    ``shard_batch``: up to rounding, the unsharded step on the whole
    batch, on any (data, space) mesh.

    The state keeps one set of weights (``TrainState`` holds the module;
    the JAX package replicates a pytree). Each shard runs a skeleton of
    the model (a copy on the meta device) by ``torch.func.functional_call``
    on the state's weights moved to its device, in a thread of its own
    (the step keeps one a shard, shut down when the step is collected);
    the shards meet at each train BatchNorm (``core.bands.shard_context``),
    which normalizes with the whole batch's moments and moves the running
    stats once. With ``space`` > 1 a shard holds a band of rows of each
    activation, and the ops that read across rows meet its data row
    (``core.bands``: convolutions gather the rows they read, the pool and
    the resizes read the row's bands, sizes are global) where XLA's
    partitioner inserts its halo exchanges. The loss is every shard's
    NLL sums over the global counts (``combine_loss_terms``). All of it
    is one autograd graph: one backward of that loss gives the whole
    batch's gradients on the state's weights, the optimizer's clip reads
    their norm, and the update and Polyak run once. Nothing waits inside
    the backward, so logical shards on one card (``[cuda:0] * n``) do not
    deadlock in autograd's one worker thread for that card."""
    from segtpu_torch.engine.trainer import (_check_genotype,
                                             combine_loss_terms)
    parts = getattr(step_fn, "parts", None)
    if parts is None:
        raise TypeError("make_sharded_train_step shards a make_train_step "
                        "step (one that carries its StepParts)")
    devices = mesh.devices
    skeletons = []     # [model, its skeleton for each shard]

    def skeleton(model):
        if not skeletons or skeletons[0] is not model:
            skeletons[:] = [model, [copy.deepcopy(model).to("meta")
                                    for _ in devices]]
        return skeletons[1]

    def step(state, batch):
        model = state.model
        _check_genotype(model, parts.genotype)
        shards = shard_batch(mesh, batch)
        model.train()
        params = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        # rank 0 moves the running stats: into the state's own buffers,
        # or copies of them on its device, written back below
        buffers0 = {k: b.to(devices[0]) for k, b in buffers.items()}
        skels = skeleton(model)

        def run(r, dev, shard):
            tensors = {k: p.to(dev) for k, p in params.items()}
            tensors.update(buffers0 if r == 0 else
                           {k: b.to(dev) for k, b in buffers.items()})
            skel = skels[r]
            skel.train()

            def forward(*args, **kwargs):
                return torch.func.functional_call(skel, tensors, args,
                                                  kwargs)

            return parts.terms(forward, shard, dev)

        terms = _run_shards(workers, mesh, run, shards)
        with torch.no_grad():
            for k, b in buffers.items():
                if buffers0[k] is not b:
                    b.copy_(buffers0[k])
        loss = combine_loss_terms(terms, devices[0])
        return parts.update(state, loss), loss.detach()

    workers = _shard_workers(mesh, step)
    return step


def make_sharded_eval_step(eval_step, mesh: DeviceMesh):
    """-> ``eval(params, stats, batch) -> [K, K]``: ``eval_step`` (a
    ``make_eval_step`` step) on each shard of ``shard_batch`` with the
    maps moved to the shard's device, a thread a shard as the train
    step's (on a mesh with ``space`` > 1 the shards of a row meet at the
    ops that read across rows), the confusion matrices summed in shard
    order onto the mesh's first device: the unsharded matrix, exactly,
    where no argmax is a near-tie that the bands' sum order flips."""
    devices = mesh.devices

    def run(params, stats, batch):
        def one(r, dev, shard):
            return eval_step({k: p.to(dev) for k, p in params.items()},
                             {k: s.to(dev) for k, s in stats.items()},
                             shard)

        total = None
        for cm in _run_shards(workers, mesh, one, shard_batch(mesh, batch)):
            cm = cm.to(devices[0])
            total = cm if total is None else total + cm
        return total

    workers = _shard_workers(mesh, run)
    return run
